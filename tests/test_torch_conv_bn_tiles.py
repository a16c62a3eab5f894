"""The host side of the port's bf16 1x1-conv + BN kernels
(`ops.conv1x1_bn_relu`, kernel 10; `ops.conv1x1_bn_stats`, kernel 11),
which run on `csrc/gemm_tc.cuh`'s forward body, on the CPU.

* `conv_schedule` picks the narrowest tile width that holds N (256 above
  that) and one CTA an SM, at most one a tile; `matmul.fwd_tile_plan`,
  the tiles each CTA of the forward body walks, covers every 128 x width
  output tile exactly once, at every width, on the scheduled grid and
  on one CTA a tile.
* The Python tile geometry is the kernels': the row tile is
  `gemm_tc.cuh`'s BM and the widths are the instantiations the two
  launchers accept.
* Kernel 11's wrapper sizes its partials from the library's row-tile
  count and hands the schedule's width and CTAs to the launch.
* A CPU call to either wrapper launches nothing and returns the plain
  version's values; a 16-byte-misaligned operand raises on the CPU too
  (TMA takes only aligned bases).
"""

import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import conv_bn as cb
from paddle_tpu_torch.ops import matmul as mm

CSRC = Path(cb.__file__).resolve().parent / "csrc"
# chip_smoke.py's CONV_PATH (kernel 10 at B = 128, as M) and
# CONV_STATS_PATH (kernel 11): (M, N)
CONV_PATH = ((401408, 64), (401408, 64), (401408, 128), (100352, 128),
             (100352, 256), (25088, 256), (25088, 512), (6272, 512))
CONV_STATS_PATH = ((401408, 64), (401408, 256), (401408, 64),
                   (401408, 128), (100352, 512), (100352, 128),
                   (100352, 256), (25088, 1024), (25088, 256),
                   (25088, 512), (6272, 2048), (6272, 512))
# the ragged shape, an M below one tile, N = 8
EDGE = ((777, 264), (100, 64), (40, 8), (1, 8))
SHAPES = sorted(set(CONV_PATH + CONV_STATS_PATH + EDGE))


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("m,n", SHAPES)
def test_tile_plan_covers_every_tile_once_at_every_width(m, n, sms):
    for bn in cb.TILE_WIDTHS:
        rows, cols = -(-m // 128), -(-n // bn)
        assert mm.fwd_tiles(m, n, bn) == rows * cols
        for ctas in (min(rows * cols, sms), rows * cols):
            plan = mm.fwd_tile_plan(m, n, ctas, bn)
            assert len(plan) == ctas and all(plan)  # no CTA without a tile
            flat = [t for cta in plan for t in cta]
            assert sorted(flat) == [(r, c) for r in range(rows)
                                    for c in range(cols)]
            for cta in plan:                        # row-major order a CTA
                assert cta == sorted(cta)
    bn, ctas = cb.conv_schedule(m, n, sms)
    assert bn in cb.TILE_WIDTHS
    assert ctas == min(mm.fwd_tiles(m, n, bn), sms)


@pytest.mark.parametrize("n,width", [
    (8, 64), (64, 64), (72, 128), (128, 128), (136, 256), (256, 256),
    (264, 256), (512, 256), (2048, 256)])
def test_width_is_the_narrowest_that_holds_n(n, width):
    for m in (1, 6272, 401408):
        assert cb.conv_schedule(m, n)[0] == width


def test_tile_geometry_is_the_kernels():
    tc = (CSRC / "gemm_tc.cuh").read_text()
    assert int(re.search(r"constexpr int BM = (\d+);", tc).group(1)) \
        == mm.FWD_ROWS
    for src in ("conv_bn_relu.cu", "conv_bn_stats.cu"):
        text = (CSRC / src).read_text()
        cases = re.findall(r"case (\d+): return launch_tc<(\d+)>", text)
        assert all(a == b for a, b in cases)
        assert tuple(sorted(int(a) for a, _ in cases)) == cb.TILE_WIDTHS


@pytest.mark.parametrize("m,n", [(401408, 256), (777, 264), (100, 64),
                                 (6272, 2048)])
def test_stats_partials_follow_the_librarys_row_tiles(monkeypatch, m, n):
    """The wrapper asks the library for the partials' row tiles of M
    rows in bf16, allocates ``[2][tiles][N]`` f32 partials of that count
    and hands it, the width and the CTAs to the launch; the library's
    count is ceil(M / 128) (`chip_smoke.py` checks that on the card)."""
    k = 8
    asked, launched, allocs = [], [], []
    real_empty = torch.empty

    def query(lib, fn, argtypes, rows, dtype):
        asked.append((lib, fn, rows, dtype))
        return -(-rows // mm.FWD_ROWS)

    def empty(*shape, **kw):
        allocs.append((tuple(shape), kw.get("dtype")))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(_build, "query", query)
    monkeypatch.setattr(_build, "launch",
                        lambda lib, fn, argtypes, *a: launched.append(a))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch, "empty", empty)
    x = real_empty(m, k, dtype=torch.bfloat16)
    w = real_empty(n, k, dtype=torch.bfloat16)
    bn, ctas = cb.conv_schedule(m, n)
    cb._launch_conv_bn_stats(x, w, bn, ctas)
    tiles = -(-m // mm.FWD_ROWS)
    assert asked == [("conv_bn_stats", "conv_bn_stats_part_tiles", m, 1)]
    assert ((2, tiles, n), torch.float32) in allocs
    (args,) = launched
    assert args[4] == tiles                      # part_tiles
    assert args[7:10] == (m, n, k)
    assert args[10:13] == (1, bn, ctas)          # bf16, width, CTAs


def _misaligned(rows, cols, dtype):
    """A contiguous [rows, cols] view whose storage offset leaves its
    base 2 or 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 8, dtype=dtype)
    view = flat[1:1 + rows * cols].view(rows, cols)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,which", [
    ("relu", "x"), ("relu", "w"), ("relu", "scale"), ("relu", "shift"),
    ("stats", "x"), ("stats", "w")])
def test_wrappers_raise_on_a_misaligned_storage_offset(kernel, which,
                                                       dtype):
    m, k, n = 16, 8, 24
    args = {"x": torch.zeros(m, k, dtype=dtype),
            "w": torch.zeros(n, k, dtype=dtype),
            "scale": torch.ones(n), "shift": torch.zeros(n)}
    args[which] = (_misaligned(1, n, torch.float32)[0]
                   if which in ("scale", "shift")
                   else _misaligned(*args[which].shape, dtype))
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "relu":
            ops.conv1x1_bn_relu(args["x"], args["w"], args["scale"],
                                args["shift"])
        else:
            ops.conv1x1_bn_stats(args["x"], args["w"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_calls_launch_nothing(dtype):
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(300, 24, generator=g).to(dtype)
    w = torch.randn(72, 24, generator=g).to(dtype)
    scale = torch.rand(72, generator=g) + 0.5
    shift = torch.randn(72, generator=g) * 0.1
    y = ops.conv1x1_bn_relu(x, w, scale, shift)
    torch.testing.assert_close(
        y, cb.conv1x1_bn_relu_reference(x, w, scale, shift), atol=0,
        rtol=0)
    got = ops.conv1x1_bn_stats(x, w)
    for a, b in zip(got, cb.conv1x1_bn_stats_reference(x, w)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    counts = ops.launch_counts()
    assert counts["conv_bn_relu"] == 0 and counts["conv_bn_stats"] == 0
