"""Flash attention: the hand-written forward and backward kernels on CUDA
tensors, their plain PyTorch versions on CPU tensors, and the
`torch.autograd.Function` that joins them.

Counterpart of `paddle_tpu.ops.attention` (dispatch, segment ids) and
`paddle_tpu.ops.pallas.attention` (the kernels and the `_flash_core`
custom VJP).  The kernels:

* ``flash_fwd`` (``csrc/flash_fwd.cu``): O, and the row LSE the
  backward needs, with an additive row bias, segment ids and causal
  masking (bf16 on the tensor cores through TMA, which needs 16-byte
  aligned bases and strides; f32 on FMA);
* ``flash_bwd_dq`` / ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``): the
  row-parallel dQ and the column-parallel dK/dV(/dbias) pair (bf16 on
  the tensor cores through cp.async, which needs 16-byte aligned bases
  and strides; f32 on FMA);
* ``flash_bwd_fused`` (``csrc/flash_bwd_fused.cu``): dQ, dK, dV and
  dbias in one launch for short rows.

Unlike the JAX dispatch there is no size threshold: a CUDA tensor always
launches the kernels, whatever S is, and any S works (ragged edges are
masked in the kernels, not padded).  A call that needs no gradient runs
the forward without the LSE, as the engine's prefill does.

Backward dispatch (`_use_fused_bwd`): the fused kernel when it fits
(D = 64 and Sq, Sk <= 512: its dQ accumulator for every query row fits
one CTA's shared memory) and when, by a count of waves and tile steps
over the card's SMs, it beats the pair's finer grid (it needs B*H to
fill the card's waves); otherwise the dQ + dK/dV pair.
``PADDLE_TPU_FLASH_FUSED_BWD=0`` selects the pair everywhere, the
reference's own knob (`paddle_tpu/ops/pallas/attention.py:781`).  CPU
tensors take one plain backward (`flash_attention_bwd_reference`),
whatever the rule says.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_reference",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_fused", "flash_fwd",
           "normalize_segment_ids", "scaled_dot_product_attention"]

NEG_INF = -1e30
_LAYOUTS = ("BHSD", "BSHD")
FUSED_MAX_S = 512
# f32: the time of one fused 64 x 64 tile step over the pair's dQ step
# plus its dK/dV step, both kernels on FMA (the fused step shares s, p
# and dp): chip_smoke.py's flash_main_shape times on the H100 at B=60,
# S=512, taken when both dtypes still ran the FMA kernels.
FUSED_STEP_COST = 0.85
# bf16, both schedules on the tensor cores at one CTA an SM: the time of
# a wave in fused tile steps (128 keys x 64 queries), fitted to the
# bf16 times of a grid of B (1-60) and S (128-512) at H=12 on the
# H100 (NVIDIA H100 80GB HBM3, 700 W): a fused wave is FUSED_WAVE_BF16
# steps plus its CTA's ceil(Sk/128) * ceil(Sq/64); a wave of either pair
# kernel PAIR_WAVE_BF16[0] plus PAIR_WAVE_BF16[1] a 64-row tile it walks;
# the pair takes at least PAIR_MIN_BF16 steps, the host's time for its
# two launches (~0.064 ms).  A fused step reads 0.0051 ms, a fused wave
# at S=512 0.177 ms.
FUSED_WAVE_BF16 = 2.7
PAIR_WAVE_BF16 = (2.0, 0.43)
PAIR_MIN_BF16 = 12.5


class FlashParams(ctypes.Structure):
    """Mirror of ``ptt::flash::Params`` in ``csrc/flash_common.cuh``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "o", "dout", "dq", "dk", "dv", "lse", "delta",
        "dbias", "bias", "qseg", "kseg")]
        + [(n, ctypes.c_longlong * 3) for n in (
            "q_s", "k_s", "v_s", "o_s", "do_s", "dq_s", "dk_s", "dv_s")]
        + [("bias_sb", ctypes.c_longlong), ("bias_sh", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "Sq", "Sk", "D", "causal", "dtype")]
        + [("scale", ctypes.c_float)])


_ARGTYPES = [ctypes.POINTER(FlashParams), ctypes.c_void_p]


# ---------------------------------------------------------------------------
# operands shared by the plain versions and the kernels
# ---------------------------------------------------------------------------


def normalize_segment_ids(segment_ids):
    """A single [B, S] id tensor (self-attention) or a (q_seg, kv_seg)
    pair -> the explicit pair (`paddle_tpu.ops.attention.
    normalize_segment_ids`)."""
    if segment_ids is None:
        return None
    if isinstance(segment_ids, (tuple, list)):
        qseg, kseg = segment_ids
        return qseg, kseg
    return segment_ids, segment_ids


def _dims(q, k, layout):
    """(B, H, Sq, Sk, D) of q / k in ``layout``."""
    if layout == "BSHD":
        b, sq, h, d = q.shape
        return b, h, sq, k.shape[1], d
    b, h, sq, d = q.shape
    return b, h, sq, k.shape[2], d


def _to_bhsd(t, layout):
    return t.transpose(1, 2) if layout == "BSHD" else t


def _from_bhsd(t, layout):
    return t.transpose(1, 2) if layout == "BSHD" else t


def _check_bias(bias, b, h, sk):
    """A row bias must broadcast to [B, H, 1, Sk]."""
    if bias.dim() != 4 or bias.shape[2] != 1 or bias.shape[3] != sk or \
            bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h):
        raise ValueError(
            "flash_attention: bias must be a row bias of shape [B or 1, "
            "H or 1, 1, Sk] = [%d|1, %d|1, 1, %d], got %s"
            % (b, h, sk, tuple(bias.shape)))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def _scores(q, k, bias, segment_ids, scale, causal):
    """BHSD f32 masked scores, as the kernels build them: bias added,
    then segment and bottom-right causal masks to NEG_INF."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if segment_ids is not None:
        qseg, kseg = normalize_segment_ids(segment_ids)
        same = qseg[:, None, :, None] == kseg[:, None, None, :]
        s = torch.where(same, s, NEG_INF)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        vis = torch.ones(sq, sk, dtype=torch.bool,
                         device=s.device).tril(sk - sq)
        s = torch.where(vis, s, NEG_INF)
    return s


def _probs(s, lse):
    """exp(s - lse), exactly zero where masked (a dead row's lse is
    NEG_INF and must not resurrect p = 1)."""
    return torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))


def flash_attention_reference(q, k, v, bias=None, segment_ids=None,
                              scale=None, causal=False, layout="BSHD"):
    """Plain version of the ``flash_fwd`` kernel: ``(o, lse)`` with o in
    q's layout and dtype and lse ``[B*H, Sq]`` f32 (NEG_INF for a dead
    row, whose o is zeros).  bf16 inputs are upcast to f32 (the kernel's
    arithmetic)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    b, h, sq, _, _ = _dims(q, k, layout)
    s = _scores(_to_bhsd(q, layout), _to_bhsd(k, layout), bias,
                segment_ids, scale, causal)
    m = s.amax(dim=-1)
    dead = m <= NEG_INF / 2
    safe_m = torch.where(dead, 0.0, m)
    l = torch.where(s <= NEG_INF / 2, 0.0,
                    torch.exp(s - safe_m[..., None])).sum(dim=-1)
    lse = torch.where(dead, NEG_INF, safe_m + torch.log(l.clamp_min(1e-30)))
    p = _probs(s, lse)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _to_bhsd(v, layout).float())
    return _from_bhsd(o.to(q.dtype), layout), lse.reshape(b * h, sq)


def flash_attention_bwd_reference(q, k, v, bias, segment_ids, o, do, lse,
                                  scale=None, causal=False, layout="BSHD"):
    """Plain version of the backward kernels, from the forward's LSE as
    they compute it: ``(dq, dk, dv, dbias)`` with dq/dk/dv in the
    layout and dtype of q and dbias ``[B, H, 1, Sk]`` f32 (the column
    sum of dS, before any reduction to the bias's broadcast shape)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    b, h, sq, sk, _ = _dims(q, k, layout)
    qh, kh, vh, oh, doh = (_to_bhsd(t, layout).float()
                           for t in (q, k, v, o, do))
    s = _scores(qh, kh, bias, segment_ids, scale, causal)
    p = _probs(s, lse.reshape(b, h, sq).float())
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    delta = (doh * oh).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dbias = ds.sum(dim=-2, keepdim=True)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    return (_from_bhsd(dq.to(q.dtype), layout),
            _from_bhsd(dk.to(k.dtype), layout),
            _from_bhsd(dv.to(v.dtype), layout), dbias)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _bsh_strides(t, layout):
    """(batch, seq, head) element strides of a 4-D tensor."""
    st = t.stride()
    if layout == "BSHD":
        return st[0], st[1], st[2]
    return st[0], st[2], st[1]


def _check_cuda(q, k, v, layout, **more):
    """Validate the operands a kernel reads; returns (B, H, Sq, Sk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(more.items()):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: %s must lie on %s with q"
                             % (name, q.device))
        if t.dim() != 4 or t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(
                "flash_attention: %s must be a 4-D %s tensor with a "
                "unit-stride head dim, got shape %s dtype %s strides %s"
                % (name, q.dtype, tuple(t.shape), t.dtype, t.stride()))
    b, h, sq, sk, d = _dims(q, k, layout)
    kv_shape = (b, sk, h, d) if layout == "BSHD" else (b, h, sk, d)
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError("flash_attention: q %s, k %s, v %s do not agree "
                         "in layout %s" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape), layout))
    for name, t in more.items():
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError("flash_attention: %s has shape %s, q %s"
                             % (name, tuple(t.shape), tuple(q.shape)))
    if d not in (64, 128):
        raise ValueError("flash_attention: head dim must be 64 or 128, "
                         "got %d" % d)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)) + tuple(more.items()):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    "flash_attention: the bf16 kernels load 16-byte rows "
                    "(TMA, cp.async): %s needs a 16-byte-aligned base and "
                    "strides that are multiples of 8 elements, got strides "
                    "%s" % (name, t.stride()))
    return b, h, sq, sk, d


def _check_rows(device, bh, sq, **rows):
    """The backward's row statistics (lse, delta) the kernels read:
    contiguous f32 ``[B*H, Sq]`` on ``device``."""
    for name, t in rows.items():
        if (tuple(t.shape) != (bh, sq) or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                "flash_attention: %s must be a contiguous f32 [B*H, Sq] = "
                "[%d, %d] tensor on %s, got %s %s on %s"
                % (name, bh, sq, device, tuple(t.shape), t.dtype, t.device))


def _params(q, k, v, bias, segment_ids, scale, causal, layout, **ptrs):
    """The kernel parameter block.  Returns (params, keep): ``keep``
    holds the normalized bias / segment-id tensors the pointers refer
    to, alive until the launch has been queued."""
    b, h, sq, sk, d = _dims(q, k, layout)
    p = FlashParams(B=b, H=h, Sq=sq, Sk=sk, D=d, causal=int(bool(causal)),
                    dtype=_build.dtype_code(q), scale=float(scale))
    keep = []
    if bias is not None:
        _check_bias(bias, b, h, sk)
        bt = bias.to(device=q.device, dtype=torch.float32)
        if bt.stride(3) != 1:
            bt = bt.contiguous()
        keep.append(bt)
        p.bias = bt.data_ptr()
        p.bias_sb = bt.stride(0) if bt.shape[0] > 1 else 0
        p.bias_sh = bt.stride(1) if bt.shape[1] > 1 else 0
    if segment_ids is not None:
        qseg, kseg = normalize_segment_ids(segment_ids)
        qseg = qseg.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kseg.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(qseg.shape) != (b, sq) or tuple(kseg.shape) != (b, sk):
            raise ValueError(
                "flash_attention: segment ids must be [B, Sq] = [%d, %d] "
                "and [B, Sk] = [%d, %d], got %s and %s"
                % (b, sq, b, sk, tuple(qseg.shape), tuple(kseg.shape)))
        keep += [qseg, kseg]
        p.qseg, p.kseg = qseg.data_ptr(), kseg.data_ptr()
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(ptrs.items()):
        if t is None:
            continue
        setattr(p, name, t.data_ptr())
        if t.dim() == 4:
            getattr(p, "do_s" if name == "dout" else name + "_s")[:] = (
                _bsh_strides(t, layout))
    return p, keep


def _launch(fn_name, lib_name, q, params):
    _build.launch(lib_name, fn_name, _ARGTYPES, ctypes.byref(params),
                  _build.stream_ptr(q.device))


def flash_fwd(q, k, v, bias=None, segment_ids=None, scale=None,
              causal=False, layout="BSHD", with_lse=False):
    """The forward kernel: ``(o, lse)``, lse ``[B*H, Sq]`` f32 when
    ``with_lse`` (the backward's residual), else None on the card.  CPU
    tensors take the plain version (which always returns the lse)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, bias, segment_ids, scale,
                                         causal, layout)
    b, h, sq, _, _ = _check_cuda(q, k, v, layout)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    p, _keep = _params(q, k, v, bias, segment_ids, scale, causal, layout,
                       o=o, lse=lse)
    _launch("flash_fwd", "flash_fwd", q, p)
    flash_fwd.launches += 1
    return o, lse


def _bwd_outputs(q, k, v, need):
    out = {}
    for name, like in (("dq", q), ("dk", k), ("dv", v)):
        if name in need:
            out[name] = torch.empty_like(
                like, memory_format=torch.contiguous_format)
    return out


def _dbias_buffer(q, k, layout, bias_grad):
    if not bias_grad:
        return None
    b, h, _, sk, _ = _dims(q, k, layout)
    return torch.empty(b * h, sk, dtype=torch.float32, device=q.device)


def _dbias_out(db, q, k, layout):
    b, h, _, sk, _ = _dims(q, k, layout)
    return db.reshape(b, h, 1, sk)


def _pair_launch(q, k, v, o, do, lse, delta, bias, segment_ids, scale,
                 causal, layout, bias_grad, dq, dkv):
    """Launch the pair's ``dq`` and/or ``dkv`` kernel, in that order, from
    one parameter block on CUDA tensors.  ``delta`` None: the dQ kernel
    writes it into a new buffer.  Returns ``(outputs, delta, dbias
    buffer)``, outputs a dict of dq / dk / dv."""
    b, h, sq, _, _ = _check_cuda(q, k, v, layout, o=o, do=do)
    rows = dict(lse=lse) if delta is None else dict(lse=lse, delta=delta)
    _check_rows(q.device, b * h, sq, **rows)
    if delta is None:
        delta = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    out = _bwd_outputs(q, k, v, (("dq",) if dq else ())
                       + (("dk", "dv") if dkv else ()))
    db = _dbias_buffer(q, k, layout, bias_grad and dkv)
    p, _keep = _params(q, k, v, bias, segment_ids, scale, causal, layout,
                       o=o, dout=do, lse=lse, delta=delta, dbias=db, **out)
    if dq:
        _launch("flash_bwd_dq", "flash_bwd", q, p)
        flash_bwd_dq.launches += 1
    if dkv:
        _launch("flash_bwd_dkv", "flash_bwd", q, p)
        flash_bwd_dkv.launches += 1
    return out, delta, (None if db is None else _dbias_out(db, q, k, layout))


def flash_bwd_dq(q, k, v, o, do, lse, bias=None, segment_ids=None,
                 scale=None, causal=False, layout="BSHD"):
    """The row-parallel dQ kernel: ``(dq, delta)`` with delta =
    rowsum(dO * O) ``[B*H, Sq]`` f32, which `flash_bwd_dkv` reads.
    CPU tensors take the plain version."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        b, h, sq, _, _ = _dims(q, k, layout)
        delta = (_to_bhsd(do, layout).float() * _to_bhsd(o, layout).float()
                 ).sum(dim=-1).reshape(b * h, sq)
        return _plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale,
                          causal, layout, False)[0], delta
    out, delta, _ = _pair_launch(q, k, v, o, do, lse, None, bias,
                                 segment_ids, scale, causal, layout, False,
                                 dq=True, dkv=False)
    return out["dq"], delta


def flash_bwd_dkv(q, k, v, o, do, lse, delta, bias=None, segment_ids=None,
                  scale=None, causal=False, layout="BSHD", bias_grad=False):
    """The column-parallel dK/dV kernel: ``(dk, dv, dbias)``, dbias
    ``[B, H, 1, Sk]`` f32 when ``bias_grad`` else None.  Reads the
    ``delta`` of `flash_bwd_dq`.  CPU tensors take the plain version."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        return _plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale,
                          causal, layout, bias_grad)[1:]
    out, _, db = _pair_launch(q, k, v, o, do, lse, delta, bias, segment_ids,
                              scale, causal, layout, bias_grad, dq=False,
                              dkv=True)
    return out["dk"], out["dv"], db


def flash_bwd_fused(q, k, v, o, do, lse, bias=None, segment_ids=None,
                    scale=None, causal=False, layout="BSHD", bias_grad=False):
    """The fused short-row backward kernel: ``(dq, dk, dv, dbias)`` in
    one launch (D = 64, Sq and Sk <= 512).  CPU tensors take the plain
    version."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        return _plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale,
                          causal, layout, bias_grad)
    b, h, sq, sk, d = _check_cuda(q, k, v, layout, o=o, do=do)
    _check_rows(q.device, b * h, sq, lse=lse)
    if not _fits_fused(sq, sk, d):
        raise ValueError(
            "flash_bwd_fused takes D = 64 and Sq, Sk <= %d, got D=%d "
            "Sq=%d Sk=%d" % (FUSED_MAX_S, d, sq, sk))
    out = _bwd_outputs(q, k, v, ("dq", "dk", "dv"))
    db = _dbias_buffer(q, k, layout, bias_grad)
    p, _keep = _params(q, k, v, bias, segment_ids, scale, causal, layout,
                       o=o, dout=do, lse=lse, dbias=db, **out)
    _launch("flash_bwd_fused", "flash_bwd_fused", q, p)
    flash_bwd_fused.launches += 1
    return out["dq"], out["dk"], out["dv"], (
        None if db is None else _dbias_out(db, q, k, layout))


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_bwd_fused):
    _fn.launches = 0


def _plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale, causal,
               layout, bias_grad):
    """The backward's plain version for CPU tensors: ``(dq, dk, dv,
    dbias)``, dbias None unless ``bias_grad``.  The CPU branch of every
    backward wrapper is a slice of this one call."""
    dq, dk, dv, db = flash_attention_bwd_reference(
        q, k, v, bias, segment_ids, o, do, lse, scale, causal, layout)
    return dq, dk, dv, db if bias_grad else None


def _fits_fused(sq, sk, d):
    return d == 64 and sq <= FUSED_MAX_S and sk <= FUSED_MAX_S


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _use_fused_bwd(bh, sq, sk, d, sms, dtype):
    """The backward schedule for ``bh`` = B*H heads of ``dtype`` on a card
    of ``sms`` SMs: fused when it fits (`_fits_fused`), unless
    ``PADDLE_TPU_FLASH_FUSED_BWD=0``, and only when it is the faster by
    a count of waves and tile steps.

    bf16: both schedules run on the tensor cores, one CTA an SM.  The
    fused grid is one CTA a head, so it takes ceil(bh / sms) waves of
    FUSED_WAVE_BF16 + ceil(Sk / 128) * ceil(Sq / 64) steps; the pair's
    grids are 4x finer at S=512 (a CTA a 128-row tile: dQ ceil(Sq / 128)
    CTAs a head walking ceil(Sk / 64) key tiles, dK/dV ceil(Sk / 128)
    walking ceil(Sq / 64) query tiles), each wave costing
    PAIR_WAVE_BF16, and at least PAIR_MIN_BF16 for its two launches.
    So the fused kernel wins where its waves are full (B=60, H=12: 720
    heads; B=10-11 at S=512) or the work is small (S <= 256 at B <= 4),
    and the pair where the fused kernel's last wave is mostly empty (B=1-2
    and 12-16 at S=512).

    f32: both schedules put one CTA on an SM and walk the score tiles in
    64 x 64 steps.  With ``nt`` = ceil(Sk / 64), the fused grid is one
    CTA per head doing nt^2 steps, so it takes ceil(bh / sms) * nt^2
    fused steps; each pair kernel is ceil(Sq / 64) CTAs per head doing
    nt steps, so the pair takes ceil(bh * ceil(Sq / 64) / sms) * nt steps
    of dQ plus dK/dV.  A fused step costs FUSED_STEP_COST of the pair's.
    So the fused kernel wins at a full card (B=60, H=12: 720 heads, 6
    waves of 132) and loses where its last wave is mostly empty."""
    if (not _fits_fused(sq, sk, d)
            or os.getenv("PADDLE_TPU_FLASH_FUSED_BWD", "1") == "0"):
        return False
    if dtype == torch.bfloat16:
        p0, p1 = PAIR_WAVE_BF16
        fused = -(-bh // sms) * (FUSED_WAVE_BF16
                                 + -(-sk // 128) * -(-sq // 64))
        pair = (-(-bh * -(-sq // 128) // sms) * (p0 + p1 * -(-sk // 64))
                + -(-bh * -(-sk // 128) // sms) * (p0 + p1 * -(-sq // 64)))
        return fused <= max(pair, PAIR_MIN_BF16)
    nt, mt = -(-sk // 64), -(-sq // 64)
    fused = -(-bh // sms) * nt * nt * FUSED_STEP_COST
    pair = -(-bh * mt // sms) * nt
    return fused <= pair


def flash_attention_bwd(q, k, v, o, do, lse, bias=None, segment_ids=None,
                        scale=None, causal=False, layout="BSHD",
                        bias_grad=False):
    """The flash backward: ``(dq, dk, dv, dbias)`` through the fused
    kernel or the dQ + dK/dV pair (`_use_fused_bwd`), or on CPU tensors
    through the plain version.  dbias is ``[B, H, 1, Sk]`` f32 when
    ``bias_grad``, else None."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        return _plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale,
                          causal, layout, bias_grad)
    b, h, sq, sk, d = _dims(q, k, layout)
    if _use_fused_bwd(b * h, sq, sk, d, _sm_count(q.device), q.dtype):
        return flash_bwd_fused(q, k, v, o, do, lse, bias, segment_ids, scale,
                               causal, layout, bias_grad)
    out, _, db = _pair_launch(q, k, v, o, do, lse, None, bias, segment_ids,
                              scale, causal, layout, bias_grad, dq=True,
                              dkv=True)
    return out["dq"], out["dk"], out["dv"], db


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """`_flash_core`'s custom VJP: the forward saves O and the LSE; the
    backward recomputes P from them (`flash_attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, qseg, kseg, scale, causal, layout):
        segs = None if qseg is None else (qseg, kseg)
        o, lse = flash_fwd(q, k, v, bias, segs, scale, causal, layout,
                           with_lse=True)
        ctx.save_for_backward(q, k, v, bias, qseg, kseg, o, lse)
        ctx.opts = (scale, causal, layout)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, qseg, kseg, o, lse = ctx.saved_tensors
        scale, causal, layout = ctx.opts
        segs = None if qseg is None else (qseg, kseg)
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv, db = flash_attention_bwd(
            q, k, v, o, do, lse, bias, segs, scale, causal, layout,
            bias_grad)
        if db is not None:
            db = db.sum_to_size(bias.shape).to(bias.dtype)
        return dq, dk, dv, db, None, None, None, None, None


def flash_attention(q, k, v, bias=None, segment_ids=None, scale=None,
                    causal=False, layout="BSHD"):
    """q/k/v: [B, S, H, D] (layout="BSHD") or [B, H, S, D] ("BHSD").

    * ``bias``: None or an additive row bias broadcastable as
      [B or 1, H or 1, 1, Sk] (padding masks); it gets a gradient when
      it requires one.
    * ``segment_ids``: None, a [B, S] int tensor (self-attention
      packing) or a (q_seg [B, Sq], kv_seg [B, Sk]) pair: attention is
      confined to equal ids.
    * ``causal``: bottom-right aligned (row i sees key j iff
      j <= i + Sk - Sq).  A row with no visible key emits zeros.

    f32 or bf16 in, same dtype out, f32 arithmetic.  CUDA tensors launch
    the kernels (head dim 64 or 128, last dim unit stride; other strides
    are read as given, so no copy is made); CPU tensors take the plain
    versions.  Differentiable in q, k, v and bias."""
    if layout not in _LAYOUTS:
        raise ValueError("layout must be BHSD or BSHD, got %r" % (layout,))
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    scale = float(scale)
    if bias is not None:
        b, h, _, sk, _ = _dims(q, k, layout)
        _check_bias(bias, b, h, sk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        segs = normalize_segment_ids(segment_ids)
        qseg, kseg = segs if segs is not None else (None, None)
        return _FlashAttention.apply(q, k, v, bias, qseg, kseg, scale,
                                     causal, layout)
    o, _ = flash_fwd(q, k, v, bias, segment_ids, scale, causal, layout)
    return o


def scaled_dot_product_attention(q, k, v, bias=None, segment_ids=None,
                                 scale=None, causal=False, layout="BHSD"):
    """The dispatch of `paddle_tpu.ops.attention`: the flash kernels for
    CUDA tensors at every size, the plain versions for CPU tensors."""
    return flash_attention(q, k, v, bias=bias, segment_ids=segment_ids,
                           scale=scale, causal=causal, layout=layout)
