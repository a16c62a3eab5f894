"""`paddle_tpu_torch.observability.slo` against `paddle_tpu.observability
.slo`: the same record streams through both packages' `SLOEngine` give
equal reports (objective values, goodput, burn rates), equal
`live_summary` values and equal alert transitions and counters; the
`RegressionSentinel` rules give equal verdicts on synthetic summaries;
and the platform probe reads torch, not JAX.
"""

import numpy as np
import pytest

from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import slo as jax_slo
from paddle_tpu_torch.observability import metrics, slo

T0 = 1_000_000.0


def _records(rng, n, t0, bad_share=0.0, shed_share=0.0, err_share=0.0,
             tag="r"):
    """n synthetic per-request records one second apart: latencies from
    ``rng``, a share of them slow, shed or failed."""
    out = []
    for i in range(n):
        u = rng.rand()
        if u < shed_share:
            out.append({"request_id": "%s%d" % (tag, i), "t_wall": t0 + i,
                        "outcome": "shed", "ttft_ms": None, "itl_ms": None,
                        "n_tokens": 0, "duration_ms": 0.0})
            continue
        slow = rng.rand() < bad_share
        ttft = float(rng.uniform(20, 80)) * (20 if slow else 1)
        itl = float(rng.uniform(5, 15)) * (20 if slow else 1)
        n_tok = int(rng.randint(1, 64))
        out.append({"request_id": "%s%d" % (tag, i), "t_wall": t0 + i,
                    "outcome": "error" if u > 1 - err_share else "ok",
                    "ttft_ms": ttft, "itl_ms": itl if n_tok > 1 else None,
                    "n_tokens": n_tok,
                    "duration_ms": ttft + itl * (n_tok - 1)})
    return out


def _engines(**kw):
    now = [T0]
    clock = (lambda: now[0])
    ours = slo.SLOEngine(registry=metrics.MetricsRegistry(), clock=clock,
                         **kw)
    ref = jax_slo.SLOEngine(registry=jax_metrics.MetricsRegistry(),
                            clock=clock, **kw)
    return ours, ref, now


@pytest.mark.parametrize("window", [16, 512])
def test_reports_and_alert_transitions_equal_jax(window):
    """Clean traffic, then a slow and shedding burst (alerts fire), then
    clean traffic again until the burst leaves the window (they clear):
    every report, alert list and alert counter equal across packages."""
    ours, ref, now = _engines(window=window, burn_windows=(30.0, 300.0))
    rng = np.random.RandomState(0)
    phases = [_records(rng, 40, T0, tag="a"),
              _records(rng, 40, T0 + 40, bad_share=0.5, shed_share=0.2,
                       err_share=0.1, tag="b"),
              _records(rng, 600, T0 + 80, tag="c")]
    alerts = []
    for recs in phases:
        for r in recs:
            ours.record(dict(r))
            ref.record(dict(r))
        now[0] = recs[-1]["t_wall"]
        a, b = ours.evaluate(), ref.evaluate()
        assert a == b
        assert ours.live_summary() == ref.live_summary()
        assert len(ours) == len(ref)
        alerts.append(a["alerts"])
    assert alerts[0] == [] and alerts[2] == []
    assert {"itl_p99", "shed_rate", "ttft_p99"} <= set(alerts[1])
    for name in ("ttft_p99", "itl_p99", "shed_rate", "error_rate"):
        assert ours._m_alerts.labels("serving", name).value == \
            ref._m_alerts.labels("serving", name).value


def test_record_fills_t_wall_and_report_evaluates():
    ours, ref, now = _engines(objectives=[
        slo.Objective("d", "duration_ms", 100.0, percentile=99)])
    for eng in (ours, ref):
        eng.record({"outcome": "ok", "duration_ms": 150.0, "ttft_ms": 1.0})
        eng.record({"outcome": "ok", "duration_ms": 50.0, "ttft_ms": 2.0})
    assert ours.report() == ref.report()
    assert ours.alerts() == ref.alerts() == ["d"]
    assert ours._records[0]["t_wall"] == T0


@pytest.mark.parametrize("values,q", [([], 50), ([3.0], 99),
                                      ([5, 1, 4, 2, 3], 0),
                                      ([5, 1, 4, 2, 3], 50),
                                      (list(range(100)), 99),
                                      (list(range(7)), 100)])
def test_percentile_equals_jax(values, q):
    assert slo.percentile(values, q) == jax_slo.percentile(values, q)


def test_objective_validation_and_defaults_as_jax():
    with pytest.raises(ValueError, match="unknown SLO metric"):
        slo.Objective("x", "tokens", 1.0)
    with pytest.raises(ValueError, match="target"):
        slo.SLOEngine(target=1.0, registry=metrics.MetricsRegistry())
    assert [o.describe() for o in slo.default_objectives(100, 10)] == \
        [o.describe() for o in jax_slo.default_objectives(100, 10)]


BASE = {"platform": "cpu", "ttft_ms_p99": 100.0, "itl_ms_p99": 10.0,
        "tokens_per_s": 500.0, "decode_executables": 1}


@pytest.mark.parametrize("live", [
    {"ttft_ms_p99": 110.0, "itl_ms_p99": 9.0, "tokens_per_s": 480.0,
     "decode_executables": 1},
    {"ttft_ms_p99": 130.0, "itl_ms_p99": 9.0, "tokens_per_s": 480.0},
    {"itl_ms_p99": 13.0, "tokens_per_s": 300.0},
    {"decode_executables": 2},
    {"ttft_ms_p99": None, "tokens_per_s": None}],
    ids=["ok", "latency", "itl_and_throughput", "compiles", "empty"])
def test_sentinel_rules_equal_jax(live):
    ours = slo.RegressionSentinel(BASE, platform="cpu",
                                  registry=metrics.MetricsRegistry())
    ref = jax_slo.RegressionSentinel(BASE, platform="cpu",
                                     registry=jax_metrics.MetricsRegistry())
    a, b = ours.check(live), ref.check(live)
    assert a == b and a["checked"]
    assert ours.gate(lambda: live)() == a


def test_sentinel_never_gates_another_platform():
    ours = slo.RegressionSentinel(dict(BASE, platform="tpu"),
                                  platform="gpu",
                                  registry=metrics.MetricsRegistry())
    out = ours.check({"ttft_ms_p99": 1e9})
    assert out["checked"] is False and not out["regressed"]
    assert "'tpu' != live 'gpu'" in out["skipped"]


def test_sentinel_from_bench_file_as_jax(tmp_path):
    path = tmp_path / "bench.json"
    path.write_text('[{"metric": "ttft_ms_p99", "value": 80.0, '
                    '"platform": "gpu"}, {"metric": "other", "value": 1}]')
    ours = slo.RegressionSentinel.from_bench_file(
        str(path), platform="gpu", registry=metrics.MetricsRegistry())
    ref = jax_slo.RegressionSentinel.from_bench_file(
        str(path), platform="gpu", registry=jax_metrics.MetricsRegistry())
    assert ours.baseline == ref.baseline == {"ttft_ms_p99": 80.0,
                                             "platform": "gpu"}


def test_platform_probe_reads_torch(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert slo._current_platform() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert slo._current_platform() == "gpu"
    assert slo.RegressionSentinel(
        BASE, registry=metrics.MetricsRegistry()).platform == "gpu"
