"""The port's index ops at negative and out-of-range ids, held against
`paddle_tpu.fluid`'s lowerings on the CPU, and the Momentum signature.

* `BAD_IDS`: numpy-only cases (`chip_smoke.py` runs the same on the card
  against the CPU) of ``gather`` (axis 0 and 1), ``lookup_table`` /
  ``lookup_table_v2``, ``gather_nd`` and ``scatter`` (both forms) at ids
  in [-n, 0), below -n and at or past n.  The reference's values:
  ``jnp.take`` wraps [-n, 0) and fills a NaN row (an integer table: its
  least value) past either end; indexing (``gather_nd``) wraps then
  clamps; ``.at[ids].set`` / ``.add`` wrap and drop the rest.  Each
  forward equals the JAX lowering within 1e-6 (NaN where JAX's is NaN,
  integers exactly) and runs on meta tensors; each ``vjp_grad`` equals
  JAX's within 1e-5 (a bad id contributes nothing: not a take's row,
  nor an element ``gather_nd`` read through a clamp, nor a dropped
  update), recomputed and taped.
* ``pad`` with a negative padding raises in both packages (``jnp.pad``
  refuses it; `F.pad` would crop).
* ``MomentumOptimizer(0.1)`` raises TypeError in both packages:
  ``momentum`` is required.

This module imports numpy and torch only at its top; the JAX package is
imported inside the tests.
"""

import numpy as np
import pytest
import torch


def _r(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# (op type, {slot: [numpy inputs]}, attrs)
BAD_IDS = {
    "gather-axis0": ("gather", {"X": [_r(5, 3)], "Index": [
        np.array([-1, 5, -6, 0, 4, -5, 9], np.int64)]}, {"axis": 0}),
    "gather-axis1": ("gather", {"X": [_r(2, 5, 3)], "Index": [
        np.array([[-2, 7], [5, 1]], np.int32)]}, {"axis": 1}),
    "gather-int": ("gather", {"X": [np.arange(12, dtype=np.int32)
                                    .reshape(4, 3)],
                              "Index": [np.array([-1, 4, 2], np.int64)]},
                   {"axis": 0}),
    "lookup_table": ("lookup_table", {"W": [_r(10, 4)], "Ids": [
        np.array([[-1, 3, 10], [-11, 0, 12]], np.int64)]},
                     {"padding_idx": -1}),
    "lookup_table-padding": ("lookup_table", {"W": [_r(10, 4)], "Ids": [
        np.array([[[2], [-3]], [[15], [2]]], np.int64)]},
                             {"padding_idx": 2}),
    "lookup_table_v2": ("lookup_table_v2", {"W": [_r(10, 4)], "Ids": [
        np.array([-10, 9, -12, 100], np.int64)]}, {"padding_idx": -1}),
    "gather_nd": ("gather_nd", {"X": [_r(3, 4, 5)], "Index": [
        np.array([[-1, 2], [3, -7], [-4, 9], [2, 3]], np.int64)]}, {}),
    "scatter-overwrite": ("scatter", {
        "X": [_r(5, 3)], "Ids": [np.array([-1, 5, -6, 1, 7], np.int64)],
        "Updates": [_r(5, 3, seed=1)]}, {"overwrite": True}),
    "scatter-add": ("scatter", {
        "X": [_r(5, 3)], "Ids": [np.array([-1, 4, 5, -6, -1, 0], np.int64)],
        "Updates": [_r(6, 3, seed=1)]}, {"overwrite": False}),
}

FWD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    from torch_static_common import jax_state_unchanged

    with jax_state_unchanged():
        yield


def test_the_cases_hold_bad_ids():
    """Every case holds an id below -n and one at or past n (and a
    lookup one in [-n, 0)), so none of them is in-range only."""
    for case, (op_type, ins, _) in BAD_IDS.items():
        ids = ins.get("Index", ins.get("Ids"))[0]
        n = ins.get("X", ins.get("W"))[0].shape
        if op_type == "gather_nd":
            hi = np.array(n[:ids.shape[-1]])
            assert (ids < -hi).any() and (ids >= hi).any(), case
            continue
        axis = 1 if case == "gather-axis1" else 0
        assert (ids < -n[axis]).any() or (ids >= n[axis]).any(), case
        assert (ids < 0).any(), case


@pytest.mark.parametrize("case", sorted(BAD_IDS))
def test_index_op_at_bad_ids_matches_the_jax_lowering(case):
    from test_torch_static_ops import _jax_run, _port_run

    op_type, ins, attrs = BAD_IDS[case]
    want = _jax_run(op_type, ins, attrs)
    got = _port_run(op_type, ins, attrs)
    meta = _port_run(op_type, ins, attrs, device="meta")
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, m, w in zip(got[slot], meta[slot], want[slot]):
            assert tuple(g.shape) == tuple(m.shape) == w.shape, case
            if g.is_floating_point():
                np.testing.assert_array_equal(np.isnan(g.numpy()),
                                              np.isnan(w), err_msg=case)
                np.testing.assert_allclose(g.numpy(), w, **FWD_TOL,
                                           err_msg=case)
            else:
                # the reference's 32-bit JAX fills an int32 table's bad
                # rows with int32's least value, as the port does
                np.testing.assert_array_equal(g.numpy(), w, err_msg=case)


def test_the_cases_reach_every_bad_id_rule():
    """NaN rows (take), a clamp (gather_nd) and a dropped update
    (scatter) all show in the reference's own outputs."""
    from test_torch_static_ops import _jax_run

    out = {c: _jax_run(*BAD_IDS[c]) for c in BAD_IDS}
    for c in ("gather-axis0", "gather-axis1", "lookup_table",
              "lookup_table_v2"):
        assert np.isnan(out[c]["Out"][0]).any(), c
    assert (out["gather-int"]["Out"][0][1]
            == np.iinfo(np.int32).min).all()
    x = BAD_IDS["gather_nd"][1]["X"][0]
    np.testing.assert_array_equal(out["gather_nd"]["Out"][0][2], x[0, 3])
    x, upd = (BAD_IDS["scatter-add"][1][k][0] for k in ("X", "Updates"))
    want = x.copy()
    want[4] += upd[0] + upd[1] + upd[4]
    want[0] += upd[5]
    np.testing.assert_allclose(out["scatter-add"]["Out"][0], want,
                               rtol=1e-6)


@pytest.mark.parametrize("case", sorted(BAD_IDS))
@pytest.mark.parametrize("taped", [False, True])
def test_index_op_vjp_grad_at_bad_ids_matches_jax(case, taped):
    from test_torch_static_backward import assert_vjp_grad_matches

    assert_vjp_grad_matches(case, *BAD_IDS[case], taped)


def test_take_matches_jnp_take_and_gives_bad_ids_no_gradient():
    """`ops.nn_ops.take`, the one row take of the index ops and the
    eager embeddings, against ``jnp.take`` and its gradient."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.ops import nn_ops

    x = _r(6, 4, seed=3)
    # axis 0 of a 2-D table goes through F.embedding: repeated ids sum
    for axis, idx in ((0, np.array([[-1, 6], [-7, 2]])),
                      (0, np.array([1, -5, 1, 5, -1, 9, 1])),
                      (1, np.array([3, -4, -5, 4, 0]))):
        want = jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=axis)
        xt = torch.from_numpy(x).requires_grad_()
        got = nn_ops.take(xt, torch.from_numpy(idx), axis)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD_TOL)
        cot = np.random.RandomState(axis).standard_normal(
            got.shape).astype(np.float32)
        g_want = jax.grad(lambda a: jnp.sum(jnp.where(
            jnp.isnan(want), 0.0, jnp.take(a, jnp.asarray(idx), axis=axis)
            * cot)))(jnp.asarray(x))
        got.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_want),
                                   rtol=1e-6, atol=1e-6)
    empty = nn_ops.take(torch.zeros(0, 3), torch.tensor([0, -1]))
    assert empty.shape == (2, 3) and torch.isnan(empty).all()


def test_pad_refuses_a_negative_padding_as_jax_does():
    from test_torch_static_ops import _jax_run, _port_run

    ins = {"X": [_r(3, 4)]}
    attrs = {"paddings": [0, 1, -1, 2], "pad_value": 0.0}
    with pytest.raises(ValueError):
        _jax_run("pad", ins, attrs)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="negative"):
            _port_run("pad", ins, attrs, device=device)
    ok = {"paddings": [0, 1, 1, 2], "pad_value": 0.5}
    np.testing.assert_array_equal(_port_run("pad", ins, ok)["Out"][0],
                                  _jax_run("pad", ins, ok)["Out"][0])


def test_momentum_requires_momentum_in_both_packages():
    from paddle_tpu.fluid import optimizer as jax_opt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.fluid import optimizer as static_opt

    for cls in (jax_opt.MomentumOptimizer, optimizer.MomentumOptimizer,
                optimizer.Momentum, static_opt.Momentum,
                static_opt.MomentumOptimizer):
        with pytest.raises(TypeError, match="momentum"):
            cls(0.1)
    opt = optimizer.MomentumOptimizer(0.1, 0.9)
    assert (opt.momentum, opt.use_nesterov) == (0.9, False)
