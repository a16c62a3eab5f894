"""Fused-epilogue GEMM: the hand-written bias + activation GEMM and its
dX / dW(+dbias) backward kernels on CUDA tensors, their plain PyTorch
versions on CPU tensors, and the `torch.autograd.Function` that joins
them.

Counterpart of `paddle_tpu.ops.pallas.matmul` (the kernels, the
`_mba_core` custom VJP and `matmul_bias_act`).  The kernels:

* ``matmul_bias_act`` (``csrc/matmul_bias_act.cu``): ``y = act(x wᵀ +
  bias)`` with the bias and activation applied to the f32 accumulator
  before the one writeback, and optionally the pre-activation z (the
  gelu backward's residual) as a second output.  In bf16 it runs on
  `wgmma` + TMA (``csrc/gemm_tc.cuh`` `fwd_tc`), 128 x 256 output tiles
  walked by one CTA an SM (`fwd_schedule`), y and z staged in shared
  memory for TMA stores;
* ``matmul_bwd_dx`` / ``matmul_bwd_dw`` (``csrc/matmul_bwd.cu``): dX =
  dZ w and dW = dZᵀ x with dbias = the column sum of dZ, where dZ =
  dY·act'(residual) is recomputed on chip from dY and the residual and
  never written to device memory.  In bf16 they run on `wgmma` + TMA
  (``csrc/gemm_tc.cuh``) with dZ formed in registers; the dW kernel
  splits M into chunks (`dw_split_plan`) whose f32 partials, in a
  workspace from PyTorch's caching allocator, a second launch merges in
  a fixed order.

**Weight layout.**  ``w`` is ``[N, K]`` (out, in), as `nn.Linear.weight`
and `F.linear` take it, so a Linear hands its weight over with no
transpose.  The JAX package's ``w`` is ``[K, N]``; its dW is the
transpose of this one.

Residual policy (what the backward saves besides x and w), as the
reference's `_residual_kind`: gelu saves z, relu and tanh save the
output y (their derivative is a function of y), none saves nothing.

Rounding, as the reference's kernels: z accumulates in f32 and the bias
is added in f32; the output is act(z) rounded once to x's dtype; the
saved z is z rounded to x's dtype, and act' reads that rounded z.  The
backward forms dZ in f32.  On bf16 operands the card's backward rounds
dZ to bf16 once more before the tensor-core product (the plain version
contracts it in f32), which `chip_smoke.py` adds to its limit.

Unlike the JAX dispatch there is no naive fallback: a CUDA tensor always
launches the kernels, at any M, N and K (ragged edges are masked in the
kernels); bf16 operands need K and N to be multiples of 8 (16-byte
loads).  Operands must be contiguous and 16-byte aligned (TMA and
16-byte loads): the wrappers raise rather than copy, and hold that
contract on CPU tensors too.  The ``block_m/n/k``
knobs and ``PADDLE_TPU_GEMM_BLOCKS`` keep the reference's contract
(explicit non-divisors raise, explicit beats the environment) but do
not select the card's tile yet: each kernel has its own.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _build

__all__ = ["ACTIVATIONS", "dw_split_plan", "fwd_schedule",
           "fwd_tile_plan", "fwd_tiles", "matmul_bias_act",
           "matmul_bias_act_bwd_reference", "matmul_bias_act_fwd",
           "matmul_bias_act_reference", "matmul_bwd_dw", "matmul_bwd_dx"]

ACTIVATIONS = ("none", "relu", "tanh", "gelu")

# block ladder the heuristic draws from (`matmul.py:62`)
GEMM_BLOCKS = (512, 256, 128)

# activation codes shared with csrc/gemm_common.cuh (`Act`)
_ACT_CODES = {"none": 0, "relu": 1, "tanh": 2, "gelu": 3}
_GELU_TANH = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_DX_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_DW_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

# The bf16 kernels (csrc/gemm_tc.cuh): 128 x 256 outputs a CTA, 64
# contraction rows a stage.
BWD_ROWS, BWD_COLS, BWD_DEPTH = 128, 256, 64
FWD_ROWS, FWD_COLS = BWD_ROWS, BWD_COLS
# dW's split of M (`dw_split_plan`): at most MAX_SPLITS chunks; a CTA's
# pipeline fill and epilogue cost about SPLIT_OVERHEAD stages, and each
# f32 partial element, written and merged, about SPLIT_MERGE_COST.
MAX_SPLITS = 16
SPLIT_OVERHEAD = 6.0
SPLIT_MERGE_COST = 4e-6
H100_SMS = 132


# ---------------------------------------------------------------------------
# the block contract (`matmul.py:68-141`)
# ---------------------------------------------------------------------------


def _pick_block(n):
    for b in GEMM_BLOCKS:
        if n % b == 0:
            return b
    return None


def _parse_env_blocks():
    ov = os.getenv("PADDLE_TPU_GEMM_BLOCKS")
    if not ov:
        return None
    try:
        bm, bn, bk = (int(t) for t in ov.split(","))
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_GEMM_BLOCKS must be 'bm,bn,bk' (three ints), "
            "got %r" % ov) from None
    if bm <= 0 or bn <= 0 or bk <= 0:
        raise ValueError(
            "PADDLE_TPU_GEMM_BLOCKS must be three POSITIVE ints, got %r"
            % ov)
    return bm, bn, bk


def _block_sizes(m, n, k, block_m=None, block_n=None, block_k=None):
    """Resolve (bm, bn, bk) with the reference's precedence: explicit
    args RAISE on non-divisors and win over the env; a side not given
    explicitly takes the env override when it divides (warning
    otherwise) and the heuristic last.  None where no block of the
    ladder divides (the card's kernels take any shape)."""
    explicit = (block_m, block_n, block_k)
    env = _parse_env_blocks()
    if any(b is not None for b in explicit):
        out = []
        for label, dim, exp, env_b in zip(
                ("block_m", "block_n", "block_k"), (m, n, k), explicit,
                env or (None,) * 3):
            if exp is not None:
                b = int(exp)
                if not b or dim % b:
                    raise ValueError(
                        "explicit GEMM block size %s=%r must divide its "
                        "dim %d (operands [%d,%d]x[%d,%d])"
                        % (label, exp, dim, m, k, k, n))
            else:
                b = (env_b if env_b and dim % env_b == 0
                     else _pick_block(dim))
                if not b:
                    raise ValueError(
                        "cannot honor explicit GEMM block sizes: dim "
                        "%s=%d (operands [%d,%d]x[%d,%d]) is not a "
                        "multiple of 128, so no block of the ladder "
                        "divides it; drop the explicit blocks"
                        % (label.replace("block_", "").upper(), dim,
                           m, k, k, n))
            out.append(b)
        return tuple(out)
    if env is not None:
        bm, bn, bk = env
        if m % bm == 0 and n % bn == 0 and k % bk == 0:
            return bm, bn, bk
        import warnings

        warnings.warn(
            "PADDLE_TPU_GEMM_BLOCKS=%s does not divide (M=%d, N=%d, "
            "K=%d); falling back to the default block sizes"
            % (os.getenv("PADDLE_TPU_GEMM_BLOCKS"), m, n, k),
            stacklevel=3)
    return _pick_block(m), _pick_block(n), _pick_block(k)


# ---------------------------------------------------------------------------
# activations and their derivatives (f32), `matmul.py:148-192`
# ---------------------------------------------------------------------------

_SQRT_2 = 1.4142135623730951
_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT_2PI = 0.3989422804014327
_GELU_C = 0.044715


def _apply_act(z, act, approx):
    if act == "relu":
        return z.clamp_min(0.0)
    if act == "tanh":
        return torch.tanh(z)
    if act == "gelu":
        if approx:
            return 0.5 * z * (1.0 + torch.tanh(
                _SQRT_2_OVER_PI * (z + _GELU_C * z * z * z)))
        return 0.5 * z * (1.0 + torch.erf(z / _SQRT_2))
    return z


def _dact_from_residual(g, res, act, approx):
    """dZ from dY and the residual (y for relu/tanh, z for gelu)."""
    if act == "relu":
        return g * (res > 0.0).to(g.dtype)
    if act == "tanh":
        return g * (1.0 - res * res)
    if act == "gelu":
        z = res
        if approx:
            inner = _SQRT_2_OVER_PI * (z + _GELU_C * z * z * z)
            t = torch.tanh(inner)
            dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * z * z)
            return g * (0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * dinner)
        cdf = 0.5 * (1.0 + torch.erf(z / _SQRT_2))
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
        return g * (cdf + z * pdf)
    return g


def _residual_kind(act):
    """Which tensor the backward must save to recompute act'."""
    if act == "gelu":
        return "z"
    if act in ("relu", "tanh"):
        return "y"
    return None


def _check_activation(activation):
    if activation not in ACTIVATIONS:
        raise ValueError(
            "matmul_bias_act activation must be one of %s, got %r"
            % (ACTIVATIONS, activation))


def _check_args(x, w, bias, activation):
    """The reference's argument checks (`matmul.py:491-504`), with N
    read from the port's ``[N, K]`` weight."""
    _check_activation(activation)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            "matmul_bias_act is a 2-D kernel: x %s, w %s — flatten "
            "batch dims outside (the op lowering does)"
            % (tuple(x.shape), tuple(w.shape)))
    if bias is not None and (bias.dim() != 1
                             or bias.shape[0] != w.shape[0]):
        raise ValueError(
            "bias must be 1-D [N=%d], got shape %s"
            % (w.shape[0], tuple(bias.shape)))
    if x.shape[1] != w.shape[1]:
        raise ValueError(
            "matmul_bias_act: x [M, K] = %s and w [N, K] = %s disagree "
            "in K" % (tuple(x.shape), tuple(w.shape)))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def matmul_bias_act_reference(x, w, bias=None, activation="none",
                              approximate=False, emit_z=False):
    """Plain version of the forward kernel: ``(y, z)`` with y =
    act(x wᵀ + bias) and z = x wᵀ + bias (None unless ``emit_z``), both
    in x's dtype, from an f32 product and bias add; w is ``[N, K]``.

    The activation is evaluated in float64 on the f32 z and rounded once
    to x's dtype.  An f32 ``torch.tanh`` on the CPU (MKL's vmsTanh) was
    seen to land up to 3.6e-5 from the true value wherever |z| > ln 2,
    while its float64 counterpart in the same run stayed exact."""
    z = torch.matmul(x.float(), w.float().t())
    if bias is not None:
        z = z + bias.float()
    y = _apply_act(z.double(), activation, approximate).to(x.dtype)
    return y, (z.to(x.dtype) if emit_z else None)


def _dz_reference(g, res, activation, approximate):
    """dZ = dY·act'(residual) in f32."""
    return _dact_from_residual(g.float(),
                               None if res is None else res.float(),
                               activation, approximate)


def matmul_bias_act_bwd_reference(x, w, bias, res, g, activation="none",
                                  approximate=False, needs=(True, True, True)):
    """Plain version of the backward kernels: ``(dx, dw, dbias)`` from
    dY ``g`` and the residual ``res`` (z for gelu, y for relu / tanh,
    None for none), with dZ = g·act'(res) formed and contracted in f32;
    dx in x's dtype, dw ``[N, K]`` in w's, dbias in the bias's (None
    without a bias).  ``needs`` = which of the three to compute."""
    dz = _dz_reference(g, res, activation, approximate)
    dx = torch.matmul(dz, w.float()).to(x.dtype) if needs[0] else None
    dw = torch.matmul(dz.t(), x.float()).to(w.dtype) if needs[1] else None
    db = (dz.sum(dim=0).to(bias.dtype)
          if bias is not None and needs[2] else None)
    return dx, dw, db


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _cdiv(a, b):
    return -(-a // b)


def dw_split_plan(m, n, k, sms=H100_SMS):
    """The bf16 dW kernel's split of M: ``(splits, chunk)``, ``chunk`` a
    multiple of 64 rows and ``splits = ceil(m / chunk)`` chunks, none
    empty (the last may be short).  Of the splits into at most
    MAX_SPLITS chunks it takes the one a wave model finds cheapest: each
    of the ``tiles x splits`` CTAs walks its chunk's stages plus
    SPLIT_OVERHEAD, ``sms`` at a time, and a split run writes and merges
    ``splits + 1`` f32 copies of dW at SPLIT_MERGE_COST stages an
    element.  The first of equal costs wins."""
    tiles = _cdiv(n, BWD_ROWS) * _cdiv(k, BWD_COLS)
    stages = _cdiv(m, BWD_DEPTH)
    best = None
    for s in range(1, min(stages, MAX_SPLITS) + 1):
        per = _cdiv(stages, s)
        splits = _cdiv(stages, per)
        cost = _cdiv(tiles * splits, sms) * (per + SPLIT_OVERHEAD)
        if splits > 1:
            cost += (splits + 1) * n * k * SPLIT_MERGE_COST
        if best is None or cost < best[0]:
            best = (cost, splits, per * BWD_DEPTH)
    return best[1], best[2]


_SMS = {}


def _sm_count(device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _act_code(activation, approximate):
    _check_activation(activation)
    if activation == "gelu" and approximate:
        return _GELU_TANH
    return _ACT_CODES[activation]


def _check_operands(name, ref, *named):
    """Every operand a kernel reads or writes: on ``ref``'s device,
    contiguous, f32 / bf16 (the named ones in ``ref``'s dtype), and
    16-byte aligned (TMA and the 16-byte loads)."""
    for arg, t in named:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError("%s: %s must lie on %s with x" % (name, arg,
                                                             ref.device))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous, got strides %s"
                             % (name, arg, t.stride()))
        if t.dtype != ref.dtype and arg != "bias":
            raise ValueError("%s: %s is %s, x is %s" % (name, arg, t.dtype,
                                                       ref.dtype))
        _build.dtype_code(t)
        if t.data_ptr() % 16:
            raise ValueError("%s: %s must be 16-byte aligned" % (name, arg))


def _check_dims(name, dtype, m, n, k):
    if min(m, n, k) <= 0:
        raise ValueError("%s: empty operands (M=%d, N=%d, K=%d)"
                         % (name, m, n, k))
    if dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(
            "%s: bf16 operands need K and N to be multiples of 8 (16-byte "
            "loads), got K=%d, N=%d" % (name, k, n))


def _check_residual(name, res, g, activation):
    needs = _residual_kind(activation) is not None
    if (res is not None) != needs:
        raise ValueError("%s: activation %r %s a residual" % (
            name, activation, "needs" if needs else "takes no"))
    if res is not None and tuple(res.shape) != tuple(g.shape):
        raise ValueError("%s: residual %s and dY %s differ in shape"
                         % (name, tuple(res.shape), tuple(g.shape)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_tile_plan(m, n, ctas, cols=FWD_COLS):
    """The bf16 forward body's tiles, CTA by CTA, as the kernel walks
    them: CTA b takes tiles b, b + ctas, ... of the row-major order of
    the ``ceil(m / 128) x ceil(n / cols)`` output tiles; each tile as
    (row tile, column tile).  ``cols``: 256 for kernel 5, the width
    `conv_bn.conv_schedule` picks for kernels 10 and 11."""
    tiles_n = _cdiv(n, cols)
    tiles = fwd_tiles(m, n, cols)
    ctas = min(ctas, tiles)
    return [[divmod(t, tiles_n) for t in range(b, tiles, ctas)]
            for b in range(ctas)]


def fwd_tiles(m, n, cols=FWD_COLS):
    """The bf16 forward body's 128 x ``cols`` output tiles."""
    return _cdiv(n, cols) * _cdiv(m, FWD_ROWS)


def fwd_schedule(m, n, sms=H100_SMS):
    """The CTAs the bf16 forward launches: one an SM (at most one a
    tile), each walking the tiles `fwd_tile_plan` gives it, so that one
    tile's epilogue and stores overlap the loads of the next.  One CTA a
    tile was 19% slower at the FFN shape (PERF.md)."""
    return min(fwd_tiles(m, n), sms)


def matmul_bias_act_fwd(x, w, bias=None, activation="none",
                        approximate=False, emit_z=False):
    """The forward kernel: ``(y, z)``, z (x's dtype) only when
    ``emit_z``.  x ``[M, K]``, w ``[N, K]``, bias ``[N]`` f32 or bf16.
    The operand contract holds on any device; CPU tensors then take the
    plain version."""
    _check_args(x, w, bias, activation)
    m, k = x.shape
    n = w.shape[0]
    _check_operands("matmul_bias_act", x, ("x", x), ("w", w),
                    ("bias", bias))
    _check_dims("matmul_bias_act", x.dtype, m, n, k)
    if not x.is_cuda:
        return matmul_bias_act_reference(x, w, bias, activation,
                                         approximate, emit_z)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if emit_z else None
    _launch_fwd(x, w, bias, y, z, activation, approximate,
                fwd_schedule(m, n, _sm_count(x.device)))
    matmul_bias_act_fwd.launches += 1
    return y, z


def _launch_fwd(x, w, bias, y, z, activation, approximate, ctas):
    """The forward launch on ``ctas`` CTAs (bf16; the f32 kernel takes
    one a 64 x 64 tile whatever ``ctas`` says)."""
    m, k = x.shape
    _build.launch(
        "matmul_bias_act", "matmul_bias_act_fwd", _FWD_ARGTYPES, x.data_ptr(),
        w.data_ptr(), _ptr(bias), y.data_ptr(), _ptr(z), m, w.shape[0], k,
        _act_code(activation, approximate), _build.dtype_code(x),
        0 if bias is None else _build.dtype_code(bias), ctas,
        _build.stream_ptr(x.device))


def matmul_bwd_dx(g, res, w, activation="none", approximate=False):
    """The row-parallel dX kernel: dX ``[M, K]`` = (g·act'(res)) w, in
    g's dtype.  The operand contract holds on any device; CPU tensors
    then take the plain version."""
    if g.dim() != 2 or w.dim() != 2 or w.shape[0] != g.shape[1]:
        raise ValueError("matmul_bwd_dx: dY [M, N] %s and w [N, K] %s "
                         "disagree" % (tuple(g.shape), tuple(w.shape)))
    m, n = g.shape
    k = w.shape[1]
    _check_operands("matmul_bwd_dx", g, ("g", g), ("res", res), ("w", w))
    _check_dims("matmul_bwd_dx", g.dtype, m, n, k)
    _check_residual("matmul_bwd_dx", res, g, activation)
    if not g.is_cuda:
        dz = _dz_reference(g, res, activation, approximate)
        return torch.matmul(dz, w.float()).to(g.dtype)
    dx = torch.empty(m, k, dtype=g.dtype, device=g.device)
    _build.launch(
        "matmul_bwd", "matmul_bwd_dx", _DX_ARGTYPES, g.data_ptr(), _ptr(res),
        w.data_ptr(), dx.data_ptr(), m, n, k,
        _act_code(activation, approximate), _build.dtype_code(g),
        _build.stream_ptr(g.device))
    matmul_bwd_dx.launches += 1
    return dx


def matmul_bwd_dw(x, g, res, activation="none", approximate=False,
                  bias=None):
    """The column-parallel dW kernel: ``(dw, dbias)`` with dW ``[N, K]``
    = (g·act'(res))ᵀ x in x's dtype and, when ``bias`` is given, dbias
    = the column sum of dZ in the bias's dtype (taken by the CTAs of
    the first K tile alone, in a fixed order: no atomics,
    deterministic).  In bf16, M is cut as `dw_split_plan` says.  The
    operand contract holds on any device; CPU tensors then take the
    plain version."""
    if x.dim() != 2 or g.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError("matmul_bwd_dw: x [M, K] %s and dY [M, N] %s "
                         "disagree" % (tuple(x.shape), tuple(g.shape)))
    if bias is not None and tuple(bias.shape) != (g.shape[1],):
        raise ValueError("matmul_bwd_dw: bias must be [N=%d], got %s"
                         % (g.shape[1], tuple(bias.shape)))
    m, k = x.shape
    n = g.shape[1]
    _check_operands("matmul_bwd_dw", x, ("x", x), ("g", g), ("res", res))
    _check_dims("matmul_bwd_dw", x.dtype, m, n, k)
    _check_residual("matmul_bwd_dw", res, g, activation)
    if bias is not None:
        _build.dtype_code(bias)
    if not x.is_cuda:
        dz = _dz_reference(g, res, activation, approximate)
        return (torch.matmul(dz.t(), x.float()).to(x.dtype),
                None if bias is None else dz.sum(dim=0).to(bias.dtype))
    dw = torch.empty(n, k, dtype=x.dtype, device=x.device)
    db = None
    if bias is not None:
        db = torch.empty(n, dtype=bias.dtype, device=x.device)
    splits, chunk = 1, m  # the f32 kernel takes no split
    if x.dtype == torch.bfloat16:
        splits, chunk = dw_split_plan(m, n, k, _sm_count(x.device))
    _launch_dw(x, g, res, dw, db, activation, approximate, splits, chunk)
    matmul_bwd_dw.launches += 1
    return dw, db


def _launch_dw(x, g, res, dw, db, activation, approximate, splits, chunk):
    """The dW launch with an explicit plan; with ``splits`` > 1 its f32
    partials take a workspace from the caching allocator, on the
    current stream."""
    m, k = x.shape
    n = g.shape[1]
    ws = None
    if splits > 1:
        ws = torch.empty(splits * n * (k + 1), dtype=torch.float32,
                         device=x.device)
    _build.launch(
        "matmul_bwd", "matmul_bwd_dw", _DW_ARGTYPES, x.data_ptr(),
        g.data_ptr(), _ptr(res), dw.data_ptr(), _ptr(db), _ptr(ws), m, n,
        k, chunk, _act_code(activation, approximate),
        _build.dtype_code(x), 0 if db is None else _build.dtype_code(db),
        _build.stream_ptr(x.device))


for _fn in (matmul_bias_act_fwd, matmul_bwd_dx, matmul_bwd_dw):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


class _MatmulBiasAct(torch.autograd.Function):
    """`_mba_core`'s custom VJP: the forward saves x, w, the bias and the
    residual its policy names (``ctx.residual_kind``); the backward
    launches dX and dW(+dbias) only where gradients are asked for."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, approximate):
        kind = _residual_kind(activation)
        y, z = matmul_bias_act_fwd(x, w, bias, activation, approximate,
                                   emit_z=kind == "z")
        res = z if kind == "z" else (y if kind == "y" else None)
        ctx.save_for_backward(x, w, bias, res)
        ctx.opts = (activation, approximate)
        ctx.residual_kind = kind
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, bias, res = ctx.saved_tensors
        activation, approximate = ctx.opts
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        need_db = need_db and bias is not None
        if not g.is_contiguous():
            g = g.contiguous()
        if not x.is_cuda:
            dx, dw, db = matmul_bias_act_bwd_reference(
                x, w, bias, res, g, activation, approximate,
                (need_dx, need_dw, need_db))
            return dx, dw, db, None, None
        dx = dw = db = None
        if need_dx:
            dx = matmul_bwd_dx(g, res, w, activation, approximate)
        if need_dw or need_db:
            dw, db = matmul_bwd_dw(x, g, res, activation, approximate,
                                   bias if need_db else None)
        return dx, dw if need_dw else None, db, None, None


def matmul_bias_act(x, w, bias=None, activation="none", approximate=False,
                    block_m=None, block_n=None, block_k=None):
    """Fused ``[M, K] x [N, K]ᵀ`` GEMM with a bias + activation epilogue
    and a fused backward.

    ``activation``: one of {"none", "relu", "tanh", "gelu"}
    (``approximate`` selects the tanh gelu).  ``w``: ``[N, K]``, the
    `nn.Linear` layout.  ``bias``: [N] or None.  ``block_m/n/k`` keep
    the reference's contract (they must divide M/N/K or a ValueError is
    raised, and they win over ``PADDLE_TPU_GEMM_BLOCKS``) but do not
    select the card's tile.  CUDA tensors launch the kernels at any
    shape; CPU tensors take the plain versions.  Differentiable in x,
    w and bias."""
    _check_args(x, w, bias, activation)
    m, k = x.shape
    _block_sizes(m, w.shape[0], k, block_m, block_n, block_k)
    approximate = bool(approximate)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _MatmulBiasAct.apply(x, w, bias, activation, approximate)
    return matmul_bias_act_fwd(x, w, bias, activation, approximate)[0]
