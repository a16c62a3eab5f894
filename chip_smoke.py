#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version at the serving path's shapes, serves
a full-width TransformerLM through the paged generation engine, and
checks the streams against the port's sequential oracle and the dense
engine.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one, printing no
result).  Imports neither JAX nor `paddle_tpu`.  Every phase prints one
JSON line; then a ``{"kernels": [...]}`` line, the card's name and
power limit as nvidia-smi reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before that line.

Float32 products run in full f32 (TF32 off for matmul and cuDNN).
Tolerances: f32 kernels atol 1e-5 / rtol 1e-4 against the plain
version (the sums run in another order); bf16 flash atol = rtol = 2e-2
(the repo's PADDLE_TPU_FLASH_ACC policy); dense vs paged decode bitwise.
Bounds: the larger of bytes / 3.35 TB/s and flops / peak, with the
H100 SXM data-sheet peaks: 67 TFLOP/s f32 (the kernels use f32 FMA),
989 TFLOP/s bf16.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
H, D = 12, 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype],
                               msg=lambda m: "%s: %s" % (name, m))
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(ops):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.attention import naive_attention_with_layout

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(s, dt, False) for dt in (torch.float32, torch.bfloat16)
             for s in (8, 200, 512, 1024)]
    cases.append((1024, torch.float32, True))   # QKV column slices
    for s, dt, strided in cases:
        if strided:
            qkv = torch.randn(1, s, 3 * H * D, device="cuda", generator=gen)
            q, k, v = (t.view(1, s, H, D) for t in qkv.split(H * D, dim=2))
        else:
            q, k, v = (torch.randn(1, s, H, D, device="cuda", generator=gen,
                                   dtype=torch.float32).to(dt)
                       for _ in range(3))
        scale = D ** -0.5
        out = ops.flash_attention(q, k, v, scale=scale, causal=True)
        plain = lambda: naive_attention_with_layout(  # noqa: E731
            q, k, v, None, scale, True, "BSHD")
        torch.cuda.synchronize()
        err = compare("flash S=%d %s" % (s, dt), out, plain(), dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        elt = q.element_size()
        nbytes = 4 * s * H * D * elt
        flops = 4 * H * D * s * (s + 1) // 2
        bms, by = bound(nbytes, flops, dt)
        rows.append({
            "S": s, "dtype": str(dt).replace("torch.", ""),
            "strided_qkv": strided, "max_abs_err": err,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, scale=scale,
                                                      causal=True)),
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale)),
            "bound_ms": bms, "bound_by": by})
    emit({"phase": "kernel_check", "kernel": "flash_fwd", "B": 1, "H": H,
          "D": D, "causal": True, "cases": rows})
    return rows


def check_decode(ops):
    import torch.nn.functional as F

    n, t, bs = 8, 1024, 16
    mb = t // bs
    lengths_l = [0, 1, 17, 1024, 300, 511, 64, 900]
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    q = torch.randn(n, H, D, device="cuda", generator=gen)
    # a shuffled pool: slot n's live blocks are scattered pool blocks,
    # entries past ceil(len / bs) are 0 (the garbage block)
    nb = n * mb + 1
    k_pool = torch.randn(nb, bs, H, D, device="cuda", generator=gen)
    v_pool = torch.randn(nb, bs, H, D, device="cuda", generator=gen)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2))
    tables = torch.zeros(n, mb, dtype=torch.int32)
    used = 0
    for i, ln in enumerate(lengths_l):
        need = -(-ln // bs)
        tables[i, :need] = perm[used:used + need] + 1
        used += need
    tables = tables.cuda()
    k_dense = ops.paged_gather_kv(k_pool, tables).contiguous()
    v_dense = ops.paged_gather_kv(v_pool, tables).contiguous()
    scale = D ** -0.5

    dense = ops.decode_attention(q, k_dense, v_dense, lengths, scale=scale)
    paged = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                       scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(dense, paged):
        raise AssertionError(
            "dense and paged decode differ: max %g"
            % (dense - paged).abs().max().item())
    if dense[0].abs().max().item() != 0.0:
        raise AssertionError("an empty slot did not emit zeros")
    dense_plain = lambda: ops.decode_attention_reference(  # noqa: E731
        q, k_dense, v_dense, lengths, scale)
    paged_plain = lambda: ops.paged_decode_attention_reference(  # noqa: E731
        q, k_pool, v_pool, tables, lengths, scale)
    err_d = compare("decode dense", dense, dense_plain(), torch.float32)
    err_p = compare("decode paged", paged, paged_plain(), torch.float32)

    live = sum(lengths_l)
    nbytes = (2 * q.numel() * 4 + 2 * live * H * D * 4 + n * 4)
    flops = 4 * live * H * D
    bms, by = bound(nbytes, flops, torch.float32)
    live_blocks = sum(-(-ln // bs) for ln in lengths_l)
    bms_p, by_p = bound(nbytes + live_blocks * 4, flops, torch.float32)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qs, kt, vt = q[:, :, None], k_dense.transpose(1, 2), v_dense.transpose(1, 2)
    dense_row = {
        "max_abs_err": err_d,
        "ms": time_ms(lambda: ops.decode_attention(q, k_dense, v_dense,
                                                   lengths, scale=scale)),
        "plain_ms": time_ms(dense_plain),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=scale)),
        "bound_ms": bms, "bound_by": by}
    paged_row = {
        "max_abs_err": err_p,
        "ms": time_ms(lambda: ops.paged_decode_attention(
            q, k_pool, v_pool, tables, lengths, scale=scale)),
        "plain_ms": time_ms(paged_plain),
        "library_ms": None,
        "bound_ms": bms_p, "bound_by": by_p}
    emit({"phase": "kernel_check", "kernel": "decode_attention", "N": n,
          "T": t, "H": H, "D": D, "lengths": lengths_l, **dense_row})
    emit({"phase": "kernel_check", "kernel": "paged_attention", "N": n,
          "bs": bs, "max_blocks": mb, "H": H, "D": D,
          "lengths": lengths_l, "dense_equals_paged_bitwise": True,
          **paged_row})
    return dense_row, paged_row


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------


def make_requests(gen, cfg, n=16, seed=11):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(16, 701))
        prompt = rng.randint(0, cfg.vocab_size, plen)
        max_new = int(rng.randint(32, 65))
        sp = (gen.SamplingParams.greedy() if i % 2 == 0 else
              gen.SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                 seed=1000 + i))
        reqs.append(gen.GenerationRequest(
            prompt, max_new_tokens=max_new, sampling=sp,
            request_id="smoke%d" % i))
    return reqs


def serve(gen, model, reqs, **kw):
    eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [h.result(timeout=0) for h in handles]
    for r, h, s in zip(reqs, handles, streams):
        if len(s) != r.max_new_tokens or h.finish_reason != "max_new_tokens":
            raise AssertionError("%s: %d of %d tokens (%s)"
                                 % (r.request_id, len(s), r.max_new_tokens,
                                    h.finish_reason))
    if eng.paged and eng.cache.pool.used_blocks != 0:
        raise AssertionError("%d blocks never returned to the pool"
                             % eng.cache.pool.used_blocks)
    return eng, handles, streams, wall


KERNEL_CATEGORIES = (
    ("flash_fwd", "flash_fwd"),
    ("decode_paged", "paged_attention"),
    ("decode_dense", "decode_attention"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("sm90_", "matmul"),
    ("cutlass", "matmul"), ("cublas", "matmul"),
    ("sort", "sampling_sort"), ("Sort", "sampling_sort"),
    ("layer_norm", "layer_norm"),
    ("Memcpy", "copy"), ("Memset", "copy"),
    ("index", "kv_scatter_gather"), ("scatter", "kv_scatter_gather"),
    ("gather", "kv_scatter_gather"),
)


def kernel_category(name):
    for key, cat in KERNEL_CATEGORIES:
        if key in name:
            return cat
    return "other"


def profile_engine(gen, model, reqs):
    """Device time by kernel category over one engine run of ``reqs``,
    from torch.profiler's CUDA activity.  The profiler slows the host,
    so the idle share here is an upper bound on the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = gen.GenerationEngine(model, slots=8, max_len=1024)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_cat, by_name = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        for table, key in ((by_cat, kernel_category(e.name)),
                           (by_name, e.name[:90])):
            row = table.setdefault(key, [0.0, 0])
            row[0] += us
            row[1] += 1
    busy_us = sum(v[0] for v in by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "engine_profile", "requests": len(reqs),
          "decode_steps": eng.stats()["decode_steps"],
          "profiled_wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3 if by_cat else None,
          "device_idle_share": (1 - busy_us / wall_us) if by_cat else None,
          "by_category_ms": {k: [v[0] / 1e3, v[1]] for k, v in sorted(
              by_cat.items(), key=lambda kv: -kv[1][0])},
          "top_kernels_ms": [[k, v[0] / 1e3, v[1]] for k, v in top]})


def run_engine(ptt):
    gen, models, ops = ptt.generation, ptt.models, ptt.ops
    cfg = models.TransformerLMConfig(
        vocab_size=32000, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, max_position_embeddings=1024, dropout=0.0)
    t0 = time.perf_counter()
    model = models.TransformerLM(cfg, device="cuda")
    model.load_state_dict(models.from_jax_state_dict(
        models.init_params(cfg, seed=7)))
    model.eval()
    setup_s = time.perf_counter() - t0

    # the prefill forward on the card (flash kernel) against the same
    # weights on the CPU (plain versions), 64-token prompt
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 64)))
    pos = torch.arange(64)[None]
    with torch.inference_mode():
        got = model(ids.cuda(), pos.cuda()).cpu()
        cpu_model = models.TransformerLM(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        want = cpu_model.eval()(ids, pos)
    del cpu_model
    if got.shape != (1, 64, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError("bad logits %s" % (tuple(got.shape),))
    logit_err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    emit({"phase": "model_check", "logits_shape": list(got.shape),
          "card_vs_cpu_max_abs_err": logit_err, "atol": 1e-4,
          "setup_s": setup_s})

    reqs = make_requests(gen, cfg)
    serve(gen, model, reqs[:2])                  # warm-up (cuBLAS, caches)
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs)
    launches = ops.launch_counts()
    for name, c in launches.items():
        if name != "decode_attention" and c <= 0:
            raise AssertionError("kernel %s never launched on the paged "
                                 "engine run" % name)
    n_tok = sum(len(s) for s in streams)
    ttft = [(h.t_first_token - h.t_submit) * 1e3 for h in handles]
    # inter-token latency as a client sees it: every gap between two
    # tokens of one stream, prefills of other requests included
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    step = eng._m_itl.summary()
    emit({"phase": "engine", "paged": True, "requests": len(reqs),
          "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "ttft_ms_p99": float(np.percentile(ttft, 99)),
          "itl_ms_p50": float(np.percentile(itl, 50)),
          "itl_ms_p99": float(np.percentile(itl, 99)),
          "decode_step_ms_p50": step["p50"],
          "decode_step_ms_p99": step["p99"],
          "decode_steps": eng.stats()["decode_steps"],
          "prompt_lens": [len(r.prompt_ids) for r in reqs],
          "launches": launches})

    profile_engine(gen, model, reqs)

    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    sampled = [i for i in range(len(reqs)) if i not in greedy][:4]
    picked = greedy + sampled
    oracle = gen.sequential_oracle(
        lambda: gen.GenerationEngine(model, slots=8, max_len=1024),
        [reqs[i] for i in picked])
    bad = [reqs[i].request_id for i, o in zip(picked, oracle)
           if o != streams[i]]
    if bad:
        raise AssertionError("streams differ from sequential_oracle: %s"
                             % bad)

    # the dense (paged=False) path: its own run, counts from 0
    ops.reset_launch_counts()
    _, _, dense_streams, dense_wall = serve(gen, model, reqs, paged=False)
    dense_launches = ops.launch_counts()
    for name in ("flash_fwd", "decode_attention"):
        if dense_launches[name] <= 0:
            raise AssertionError("kernel %s never launched on the dense "
                                 "engine run" % name)
    launches["decode_attention"] = dense_launches["decode_attention"]
    bad = [reqs[i].request_id for i in greedy
           if dense_streams[i] != streams[i]]
    if bad:
        raise AssertionError("dense engine's greedy streams differ from "
                             "the paged engine's: %s" % bad)
    emit({"phase": "engine_checks", "oracle_requests": len(picked),
          "oracle_equal": True, "dense_greedy_equal": True,
          "dense_sampled_equal": all(dense_streams[i] == streams[i]
                                     for i in range(len(reqs))),
          "dense_tokens_per_s": n_tok / dense_wall,
          "dense_launches": dense_launches, "blocks_returned": True})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bound_hbm_tb_per_s": HBM_BYTES_PER_S / 1e12,
          "bound_peak_tflops": {str(k).replace("torch.", ""): v / 1e12
                                for k, v in PEAK_FLOPS.items()}})

    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": build_s,
          "libraries": {k: str(v) for k, v in paths.items()},
          "ptxas": ptxas})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "card", "nvidia_smi": smi})

    ops = ptt.ops
    flash_rows = check_flash(ops)
    dense_row, paged_row = check_decode(ops)
    launches = run_engine(ptt)

    main_flash = next(r for r in flash_rows
                      if r["S"] == 1024 and r["dtype"] == "float32"
                      and not r["strided_qkv"])
    src = "paddle_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces="paddle_tpu/ops/pallas/attention.py:196",
             launches=launches["flash_fwd"],
             **{k: main_flash[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")}),
        dict(name="decode_attention", route="cuda",
             source=src + "decode_attention.cu",
             replaces="paddle_tpu/ops/pallas/decode_attention.py:73",
             launches=launches["decode_attention"], **dense_row),
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:153",
             launches=launches["paged_attention"], **paged_row),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
