"""The host side of the port's bf16 GEMM forward (`ops.matmul_bias_act_fwd`,
`csrc/gemm_tc.cuh` `fwd_tc`), on the CPU.

* The wrapper holds its operand contract on CPU tensors too: a
  16-byte-misaligned storage offset raises (TMA needs aligned bases),
  and so do bf16 operands whose K or N is not a multiple of 8 (TMA's
  16-byte row strides).
* A CPU call launches no kernel and returns the plain version's values.
* `fwd_tile_plan`, the tiles each CTA of the forward walks, covers every
  128 x 256 output tile exactly once, on the grid `fwd_schedule`
  launches (one CTA an SM) and on one CTA a tile.
"""

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import matmul as port_mm


def _misaligned(rows, cols, dtype):
    """A contiguous [rows, cols] view whose storage offset leaves its
    base 2 or 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 8, dtype=dtype)
    view = flat[1:1 + rows * cols].view(rows, cols)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["x", "w", "bias"])
def test_forward_raises_on_a_misaligned_storage_offset(dtype, which):
    m, k, n = 16, 8, 24
    args = {"x": torch.zeros(m, k, dtype=dtype),
            "w": torch.zeros(n, k, dtype=dtype),
            "bias": torch.zeros(n, dtype=dtype)}
    args[which] = (_misaligned(1, n, dtype)[0] if which == "bias"
                   else _misaligned(*args[which].shape, dtype))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul_bias_act_fwd(args["x"], args["w"], args["bias"], "gelu",
                                emit_z=True)


@pytest.mark.parametrize("k,n", [(12, 16), (16, 12), (20, 36)])
def test_bf16_forward_raises_unless_k_and_n_are_multiples_of_8(k, n):
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    w = torch.zeros(n, k, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.matmul_bias_act_fwd(x, w)


def test_f32_forward_takes_any_k_and_n():
    x, w = torch.randn(3, 5), torch.randn(7, 5)
    y, _ = ops.matmul_bias_act_fwd(x, w, None, "relu")
    torch.testing.assert_close(y, (x @ w.t()).clamp_min(0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_forward_launches_nothing(dtype):
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(40, 24, generator=g).to(dtype)
    w = torch.randn(32, 24, generator=g).to(dtype)
    b = torch.randn(32, generator=g).to(dtype)
    y, z = ops.matmul_bias_act_fwd(x, w, b, "gelu", emit_z=True)
    want_y, want_z = port_mm.matmul_bias_act_reference(x, w, b, "gelu",
                                                       emit_z=True)
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(z, want_z, atol=0, rtol=0)
    assert ops.launch_counts()["matmul_bias_act"] == 0


@pytest.mark.parametrize("m,n", [(30720, 3072), (777, 200), (1, 3072),
                                 (4000, 512), (63, 264), (128, 256)])
@pytest.mark.parametrize("one_a_tile", [False, True],
                         ids=["persistent", "one_cta_a_tile"])
def test_tile_plan_covers_every_tile_once(m, n, one_a_tile):
    rows, cols = -(-m // 128), -(-n // 256)
    assert port_mm.fwd_tiles(m, n) == rows * cols
    ctas = (port_mm.fwd_tiles(m, n) if one_a_tile
            else port_mm.fwd_schedule(m, n, 132))
    assert ctas == (rows * cols if one_a_tile else min(rows * cols, 132))
    plan = port_mm.fwd_tile_plan(m, n, ctas)
    assert len(plan) == ctas and all(plan)      # no CTA without a tile
    flat = [t for cta in plan for t in cta]
    assert sorted(flat) == [(r, c) for r in range(rows)
                            for c in range(cols)]
    for cta in plan:                            # row-major order a CTA
        assert cta == sorted(cta)
