"""`paddle_tpu_torch.serving`: the generation fleet and its HTTP front on
the CPU, mirroring tests/test_generation_serving.py (``TestFleet``,
``TestHttpFront``, ``TestCtl``) and held against the JAX package:

* the fleet routes over both replicas and every stream equals the
  port's sequential oracle and the JAX engine's (greedy traffic);
* a replica death mid-generation requeues every affected request on the
  survivor exactly once (streams still the oracle's), with no finding
  of the lock sanitizer under a ``lock_delay`` drill; a 1-replica
  fleet's death fails every request loudly; a second death fails a
  requeued request; a stall trips the fleet's ITL objective;
* a canary swap reaches only the named replica, and rolls back;
* the HTTP front streams chunked ndjson equal to the non-streamed
  answer and to the in-process stream, sheds with 503 + Retry-After
  (deterministically: a fleet whose engines are not started, its queue
  full), answers 400 and 404, the GET plane, /slo and /trace;
  `tools/generation_ctl.py` ``smoke`` and ``kv`` exit 0 against it;
* `FaultPlan`, `AdmissionController` and `parse_generation_request`
  decide as the JAX package's, and there is one `ShedError` class.
"""

import http.client
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu.incubate.fault import FaultPlan as JaxFaultPlan
from paddle_tpu.serving import admission as jax_admission
from paddle_tpu.serving import generation as jax_serving_gen
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models, serving
from paddle_tpu_torch.incubate.fault import FAULT_PLAN_ENV, FaultPlan
from paddle_tpu_torch.observability import locks, trace
from paddle_tpu_torch.observability.slo import Objective

jax_gen = paddle_tpu.generation
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=128,
              dropout=0.0)          # TransformerLMConfig.tiny()
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16])


@pytest.fixture(scope="module")
def lms():
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**CFG_KW))
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = models.TransformerLM(models.TransformerLMConfig(**CFG_KW),
                              device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_fleet(lm, replicas=2, fault_plan=None, **kw):
    kw = dict(ENGINE, **kw)
    kw.setdefault("max_queue", 32)
    return serving.GenerationFleet(lm, replicas=replicas,
                                   fault_plan=fault_plan, device="cpu", **kw)


def sample_requests(n, max_new=6, module=gen):
    rng = np.random.RandomState(4)
    return [module.GenerationRequest(
        rng.randint(0, CFG_KW["vocab_size"], int(rng.randint(2, 12))),
        max_new_tokens=max_new, request_id="s%d" % i)
        for i in range(n)]


def oracle(lm, reqs, **kw):
    return gen.sequential_oracle(
        lambda: gen.GenerationEngine(lm, device="cpu", **ENGINE, **kw), reqs)


def plan_with(kind, **fields):
    return FaultPlan([], rank=0).add(kind, **fields)


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------


class TestFleet:
    def test_routes_and_matches_oracle_and_jax(self, lms):
        jm, lm = lms
        fleet = make_fleet(lm).start()
        try:
            reqs = sample_requests(6)
            handles = [fleet.submit(r) for r in reqs]
            got = [h.result(timeout=60) for h in handles]
        finally:
            fleet.stop()
        assert got == oracle(lm, reqs)
        jeng = jax_gen.GenerationEngine(jm, **ENGINE)
        assert got == jeng.generate([r.prompt_ids for r in reqs],
                                    max_new_tokens=6)
        served = [r.engine._decode_steps for r in fleet.replicas]
        assert all(s > 0 for s in served), served
        live = fleet.live_summary()
        assert live["window"] == 6 and live["decode_executables"] == 1
        assert len(fleet.slo) == 6

    def test_replica_death_requeues_exactly_once(self, lm):
        """Replica 0 dies before decode step 3 with half-generated slots;
        every affected request restarts on the survivor once and still
        matches the oracle.  A lock_delay on the engine lock widens the
        death-hook / requeue window; the sanitizer stays silent."""
        plan = plan_with("kill_replica", replica=0, request=3)
        plan.add("lock_delay", rank=0, lock="generation.engine",
                 seconds=0.002, times=50)
        reg = locks.registry()
        reg.reset()
        reg.enable()
        try:
            fleet = make_fleet(lm, fault_plan=plan).start()
            try:
                reqs = sample_requests(4, max_new=8)
                handles = [fleet.submit(r) for r in reqs]
                got = [h.result(timeout=60) for h in handles]
            finally:
                fleet.stop()
            reg.assert_clean()
        finally:
            reg.disable()
            reg.clear_delays()
        assert int(fleet._m_deaths.value) == 1
        requeued = [h for h in handles if h.requeued]
        assert requeued, "the dead replica held in-flight requests"
        assert int(fleet._m_requeued.value) == len(requeued)
        assert set(requeued) == set(
            fleet.replicas[0].engine.affected_on_death)
        assert not fleet.replicas[0].alive and fleet.ready()
        assert got == oracle(lm, reqs)

    def test_death_with_no_survivor_fails_loudly(self, lm):
        fleet = make_fleet(lm, replicas=1, fault_plan=plan_with(
            "kill_replica", replica=0, request=2)).start()
        try:
            handles = [fleet.submit(r)
                       for r in sample_requests(3, max_new=10)]
            outcomes = []
            for h in handles:
                try:
                    h.result(timeout=60)
                    outcomes.append("ok")
                except RuntimeError as e:
                    outcomes.append(str(e))
        finally:
            fleet.stop()
        assert int(fleet._m_deaths.value) == 1
        assert all("no alive replicas" in o for o in outcomes), outcomes
        assert not fleet.ready()
        with pytest.raises(RuntimeError, match="no alive replicas"):
            fleet.submit(sample_requests(1)[0])

    def test_second_death_budget_exhausted_fails_loudly(self, lm):
        fleet = make_fleet(lm, replicas=2)
        req = gen.GenerationRequest([1, 2, 3], max_new_tokens=4,
                                    request_id="unlucky")
        handle = gen.RequestHandle(req)
        handle.requeued = True          # survived one death already
        failed0 = int(fleet._m_failed.value)
        fleet._requeue_affected([handle])
        with pytest.raises(RuntimeError, match="second replica"):
            handle.result(timeout=5)
        assert int(fleet._m_failed.value) == failed0 + 1
        fleet.stop()

    def test_slot_occupancy_signal(self, lm):
        fleet = make_fleet(lm, replicas=1)
        assert fleet.slot_occupancy() == 0.0
        st = fleet.stats()
        assert st["ready"] and len(st["replicas"]) == 1
        rep = st["replicas"][0]
        assert rep["replica_id"].endswith("/g0") and rep["alive"]
        assert rep["kv_cache"]["paged"] and rep["preempted"] == 0
        fleet.stop()

    def test_stall_trips_the_itl_objective(self, lm):
        """stall_replica: one 0.4 s stall before decode step 2 puts every
        in-flight request's mean ITL (5 gaps) above 50 ms."""
        fleet = make_fleet(
            lm, replicas=1, slo_objectives=[Objective("itl", "itl_ms", 50.0)],
            fault_plan=plan_with("stall_replica", replica=0, step=2,
                                 seconds=0.4)).start()
        try:
            for h in [fleet.submit(r) for r in sample_requests(2)]:
                h.result(timeout=60)
        finally:
            fleet.stop()
        report = fleet.slo.report()
        assert report["alerts"] == ["itl"] and report["window"] == 2

    def test_canary_swap_reaches_only_the_named_replica(self, lms):
        jm, lm = lms
        with dygraph.guard():
            np.random.seed(5)
            other = jax_models.TransformerLM(jax_models.TransformerLMConfig(
                **dict(CFG_KW, initializer_range=0.5)))
        p2 = models.from_jax_state_dict(
            {k: np.asarray(v.numpy()) for k, v in other.state_dict().items()})
        before = {k: v.clone() for k, v in lm.state_dict().items()}
        reqs = sample_requests(4)
        fleet = make_fleet(lm).start()
        try:
            def on(i):
                eng = fleet.replicas[i].engine
                return [h.result(timeout=60)
                        for h in [eng.submit(r) for r in reqs]]

            snap = fleet.snapshot_params()
            r1 = fleet.replicas[1].replica_id
            assert fleet.swap_params(p2, replica_ids=[r1]) == [r1]
            base = oracle(lm, reqs)
            m2 = models.TransformerLM(models.TransformerLMConfig(**CFG_KW),
                                      device="cpu")
            m2.load_state_dict(p2)
            assert on(0) == base
            assert on(1) == oracle(m2, reqs) != base
            assert all(torch.equal(lm.state_dict()[k], v)
                       for k, v in before.items())
            bad = dict(snap, **{"ln_f.weight": torch.zeros(3)})
            with pytest.raises(ValueError):
                fleet.swap_params(bad, replica_ids=[r1])
            assert on(1) == oracle(m2, reqs)
            assert fleet.swap_params(snap) == [
                fleet.replicas[0].replica_id, r1]
            assert on(0) == on(1) == base
            with pytest.raises(RuntimeError, match="no alive replica"):
                fleet.swap_params(snap, replica_ids=["nobody"])
        finally:
            fleet.stop()

    def test_fleet_surfaces_the_engine_shed(self, lm):
        """One ShedError class: the fleet catches the engine's, tries the
        other replica, and raises it when every queue is full."""
        assert serving.ShedError is gen.ShedError
        assert serving.admission.ShedError is gen.ShedError
        fleet = make_fleet(lm, replicas=2, max_queue=1)
        fleet.submit(gen.GenerationRequest([1, 2], max_new_tokens=2))
        fleet.submit(gen.GenerationRequest([3, 4], max_new_tokens=2))
        with pytest.raises(gen.ShedError) as err:
            fleet.submit(gen.GenerationRequest([5], max_new_tokens=2))
        assert err.value.reason == "slots_full"
        assert [r.engine.occupancy()["pending"]
                for r in fleet.replicas] == [1, 1]


# ---------------------------------------------------------------------------
# fault plan, admission, request parsing: as the JAX package decides
# ---------------------------------------------------------------------------

EVENTS = [
    {"kind": "kill_replica", "replica": 1, "request": 4},
    {"kind": "kill_replica", "replica": 0, "request": 9, "gen": 1},
    {"kind": "stall_replica", "replica": 0, "step": 3, "seconds": 0.25},
    {"kind": "lock_delay", "rank": 0, "lock": "a", "seconds": 0.01,
     "times": 3},
    {"kind": "lock_delay", "rank": 1, "lock": "b", "seconds": 0.02},
]


@pytest.mark.parametrize("rank,generation", [(0, 0), (1, 0), (0, 1)])
def test_fault_plan_decides_as_jax(monkeypatch, rank, generation):
    ours = FaultPlan(EVENTS, rank=rank, generation=generation)
    ref = JaxFaultPlan(EVENTS, rank=rank, generation=generation)
    for i in range(3):
        assert ours.replica_kill_request(i) == ref.replica_kill_request(i)
        assert ours.replica_stall(i) == ref.replica_stall(i)
    assert ours.lock_delays() == ref.lock_delays()
    env = ours.to_env({"KEEP": "1"})
    assert env == ref.to_env({"KEEP": "1"}) and env["KEEP"] == "1"
    monkeypatch.setenv(FAULT_PLAN_ENV, env[FAULT_PLAN_ENV])
    again = FaultPlan.from_env(rank=rank, generation=generation)
    assert again.events == EVENTS
    monkeypatch.delenv(FAULT_PLAN_ENV)
    assert FaultPlan.from_env().events == []


def test_fault_plan_arms_lock_delays():
    reg = locks.LockRegistry()
    plan = FaultPlan(EVENTS, rank=0)
    assert plan.arm_lock_delays(reg) == 1
    assert reg._delays == [{"lock": "a", "seconds": 0.01, "times": 3}]
    assert FaultPlan(EVENTS, rank=2).arm_lock_delays(reg) == 0


@pytest.mark.parametrize("kw,args", [
    (dict(max_queue_rows=8), (4, 6, 0, 2.0)),
    (dict(max_queue_rows=8), (2, 6, 0, 0.0)),
    (dict(max_queue_rows=None, max_version_rows=5), (3, 0, 3, 10.0)),
    (dict(max_queue_rows=None, slo_ms=1000.0), (5, 30, 0, 10.0)),
    (dict(max_queue_rows=None, slo_ms=1000.0), (5, 30, 0, 0.0)),
    (dict(slo_ms=5000.0), (1, 10, 0, 4.0))],
    ids=["queue_full", "queue_ok", "version_cap", "slo", "slo_cold",
         "admit"])
def test_admission_decides_as_jax(kw, args):
    out = []
    for module in (serving.admission, jax_admission):
        ctl = module.AdmissionController(**kw)
        try:
            ctl.check(*args)
            out.append(("admit", ctl.describe()))
        except module.ShedError as e:
            out.append((e.reason, e.retry_after_s, str(e)))
    assert out[0] == out[1]


def test_parse_generation_request_as_jax():
    msg = {"prompt": [5, 7, 9], "max_new_tokens": 4, "temperature": 0.7,
           "top_k": 5, "top_p": 0.9, "seed": 3, "stop": [2],
           "request_id": "p1"}
    a = serving.parse_generation_request(msg)
    b = jax_serving_gen.parse_generation_request(msg)
    for attr in ("prompt_ids", "max_new_tokens", "stop_token_ids",
                 "request_id"):
        assert getattr(a, attr) == getattr(b, attr)
    assert a.sampling.to_dict() == b.sampling.to_dict()
    for bad in ({}, {"prompt": []}, {"prompt": "1,2"}):
        with pytest.raises(ValueError):
            serving.parse_generation_request(bad)


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------


def _post(port, body, path="/generate", timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _ndjson(conn, resp):
    records = []
    while True:
        line = resp.readline()
        if not line:
            break
        records.append(json.loads(line))
    conn.close()
    return records


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


class TestHttpFront:
    @pytest.fixture()
    def front(self, lm):
        fleet = make_fleet(lm, replicas=1, max_queue=2).start()
        port = free_port()
        httpd = serving.serve_generation_http(fleet, port=port,
                                              block=False)
        yield fleet, port
        httpd.shutdown()
        httpd.server_close()
        fleet.stop()

    def test_streamed_tokens_are_chunked_ndjson(self, front):
        _, port = front
        conn, resp = _post(port, {"prompt": [5, 7, 9], "max_new_tokens": 5,
                                  "stream": True, "request_id": "nd"})
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        assert "ndjson" in resp.getheader("Content-Type")
        assert resp.getheader("X-Request-Id") == "nd"
        records = _ndjson(conn, resp)
        toks = [r for r in records if "token" in r]
        assert [r["index"] for r in toks] == list(range(5))
        done = records[-1]
        assert done["done"] and done["n_tokens"] == 5
        assert done["reason"] == "max_new_tokens"

    def test_stream_equals_sync_and_in_process(self, front, lm):
        fleet, port = front
        body = {"prompt": [5, 7, 9], "max_new_tokens": 5}
        streamed = [r["token"] for r in _ndjson(*_post(
            port, dict(body, stream=True))) if "token" in r]
        conn, resp = _post(port, dict(body, stream=False))
        out = json.loads(resp.read())
        conn.close()
        assert out["tokens"] == streamed
        assert out["reason"] == "max_new_tokens"
        h = fleet.submit(gen.GenerationRequest([5, 7, 9], max_new_tokens=5))
        assert h.result(timeout=60) == streamed

    def test_shed_answers_503_with_retry_after(self, lm):
        """Deterministic: the fleet's engines are not started, so the
        queue stays as filled; the next request is shed."""
        fleet = make_fleet(lm, replicas=1, max_queue=1)
        port = free_port()
        httpd = serving.serve_generation_http(fleet, port=port,
                                              block=False)
        try:
            fleet.submit(gen.GenerationRequest([1, 2], max_new_tokens=2))
            conn, resp = _post(port, {"prompt": [1, 2],
                                      "max_new_tokens": 2,
                                      "stream": False})
            status = resp.status
            retry = resp.getheader("Retry-After")
            body = json.loads(resp.read())
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
        assert status == 503
        assert body["shed"] and body["reason"] == "slots_full"
        assert retry is not None and int(retry) >= 1
        shed = [r for r in fleet.replicas[0].engine.recent_requests()
                if r["outcome"] == "shed"]
        assert len(shed) == 1 and len(fleet.slo) == 1

    def test_bad_requests_400_and_404(self, front):
        _, port = front
        conn, resp = _post(port, {"prompt": []})
        assert resp.status == 400
        conn.close()
        conn, resp = _post(port, {"prompt": [1], "max_new_tokens": 500})
        assert resp.status == 400           # past max_len
        conn.close()
        conn, resp = _post(port, {"prompt": [1]}, path="/predict")
        assert resp.status == 404
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/generate", b"[1, 2]",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        assert _get(port, "/nowhere")[0] == 404

    def test_health_stats_metrics(self, front):
        _, port = front
        for path in ("/healthz", "/readyz", "/stats", "/metrics"):
            assert _get(port, path)[0] == 200, path
        stats = json.loads(_get(port, "/stats")[1])
        assert "slot_occupancy" in stats and stats["ready"]
        for rep in stats["replicas"]:
            assert rep["kv_cache"]["paged"] is True
            assert rep["kv_cache"]["blocks_free"] >= 0
            assert "blocks_used" in rep["kv_cache"]
            assert rep["preempted"] >= 0
        assert b"generation_fleet_requests_total" in _get(port,
                                                          "/metrics")[1]

    def test_slo_and_trace(self, front):
        fleet, port = front
        for r in sample_requests(3):
            fleet.submit(r).result(timeout=60)
        status, body = _get(port, "/slo")
        report = json.loads(body)
        assert status == 200 and report["window"] == 3
        assert [o["name"] for o in report["objectives"]] == [
            "ttft_p99", "itl_p99", "shed_rate", "error_rate"]
        assert _get(port, "/trace")[0] == 409
        trace.enable_tracing()
        try:
            h = fleet.submit(gen.GenerationRequest([4, 5], max_new_tokens=3))
            h.result(timeout=60)
            status, body = _get(port, "/trace?trace_id=%s"
                                % h.trace.trace_id)
        finally:
            trace.disable_tracing()
        assert status == 200
        names = {e.get("name") for e in json.loads(body)["traceEvents"]}
        assert {"request", "token"} <= names


class TestCtl:
    def _ctl(self, port, *args, timeout=120):
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "generation_ctl.py"),
             "--endpoint", "http://127.0.0.1:%d" % port, "--json", *args],
            capture_output=True, text=True, timeout=timeout)

    def test_smoke_rc0_on_healthy_fleet(self, lm):
        fleet = make_fleet(lm, replicas=1, max_queue=32).start()
        port = free_port()
        httpd = serving.serve_generation_http(fleet, port=port,
                                              block=False)
        try:
            r = self._ctl(port, "smoke", "--requests", "6", "--max-new",
                          "4", "--prompt-vocab",
                          str(CFG_KW["vocab_size"] - 1))
        finally:
            httpd.shutdown()
            httpd.server_close()
            fleet.stop()
        assert r.returncode == 0, r.stdout + r.stderr
        out = json.loads(r.stdout)
        assert out["ok"] and out["tokens"] == 6 * 4

    def test_kv_command_reports_pool_gauges(self, lm):
        fleet = make_fleet(lm, replicas=2).start()
        port = free_port()
        httpd = serving.serve_generation_http(fleet, port=port,
                                              block=False)
        try:
            r = self._ctl(port, "kv", timeout=60)
        finally:
            httpd.shutdown()
            httpd.server_close()
            fleet.stop()
        assert r.returncode == 0, r.stdout + r.stderr
        out = json.loads(r.stdout)
        assert len(out["replicas"]) == 2
        for rep in out["replicas"]:
            assert rep["paged"] is True and rep["block_size"] == 16
            assert rep["blocks_free"] >= 0 and rep["preempted"] == 0
