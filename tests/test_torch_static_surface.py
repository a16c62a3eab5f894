"""The inputs on which the ops `fluid.layers.ops` reaches are held
(`SURFACE`, merged into `tests/test_torch_static_ops.py`'s ``CASES``:
the forward and ``vjp_grad`` against the JAX lowerings there and in
`tests/test_torch_static_backward.py`), and a check that each lies in
its op's domain: every output and every gradient of the port's op on
them is finite, so no parity check compares a NaN with a NaN.

This module imports numpy and torch only (`chip_smoke.py`'s op sweep
runs the same cases on the card against the CPU).  Each op in its
domain: positive bases and logs, |x| < 1 for asin / acos / atanh /
erfinv, lgamma and digamma on (0.5, 5), well-conditioned matrices;
each attr form of the op.  Inputs placed exactly at kinks are held in
`tests/test_torch_static_layers_ops.py`.
"""

import numpy as np
import pytest
import torch


def _r(*shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def _pos(*shape, seed=0, low=0.5, high=2.5):
    """Seeded uniform inputs inside an op's domain, away from its poles."""
    return np.random.RandomState(seed).uniform(low, high, shape).astype(
        np.float32)


def _int32(shape, low, high, seed=1):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.int32)


def _spd(n, seed=0):
    a = _r(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _tri(n, seed=0):
    """A well-conditioned square matrix with a dominant diagonal."""
    return (0.3 * _r(n, n, seed=seed) + 2.0 * np.eye(n)).astype(np.float32)


def _probs(*shape, seed=0):
    e = np.exp(_r(*shape, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


SURFACE = {
    "exp": ("exp", {"X": [_r(3, 7)]}, {}),
    "log": ("log", {"X": [_pos(3, 7)]}, {}),
    "sqrt": ("sqrt", {"X": [_pos(3, 7)]}, {}),
    "rsqrt": ("rsqrt", {"X": [_pos(3, 7)]}, {}),
    "abs": ("abs", {"X": [_r(3, 7)]}, {}),
    "reciprocal": ("reciprocal",
                   {"X": [_pos(3, 7) * np.sign(_r(3, 7, seed=1))]}, {}),
    "floor": ("floor", {"X": [3 * _r(3, 7)]}, {}),
    "ceil": ("ceil", {"X": [3 * _r(3, 7)]}, {}),
    "round": ("round", {"X": [3 * _r(3, 7)]}, {}),
    "sin": ("sin", {"X": [2 * _r(3, 7)]}, {}),
    "cos": ("cos", {"X": [2 * _r(3, 7)]}, {}),
    "softplus": ("softplus", {"X": [3 * _r(3, 7)]}, {}),
    "softsign": ("softsign", {"X": [3 * _r(3, 7)]}, {}),
    "silu": ("silu", {"X": [3 * _r(3, 7)]}, {}),
    "erf": ("erf", {"X": [_r(3, 7)]}, {}),
    "sign": ("sign", {"X": [_r(3, 7)]}, {}),
    "logsigmoid": ("logsigmoid", {"X": [3 * _r(3, 7)]}, {}),
    "sinh": ("sinh", {"X": [_r(3, 7)]}, {}),
    "cosh": ("cosh", {"X": [_r(3, 7)]}, {}),
    "tan": ("tan", {"X": [_pos(3, 7, low=-1.2, high=1.2)]}, {}),
    "asin": ("asin", {"X": [_pos(3, 7, low=-0.9, high=0.9)]}, {}),
    "acos": ("acos", {"X": [_pos(3, 7, low=-0.9, high=0.9)]}, {}),
    "atan": ("atan", {"X": [2 * _r(3, 7)]}, {}),
    "asinh": ("asinh", {"X": [2 * _r(3, 7)]}, {}),
    "acosh": ("acosh", {"X": [_pos(3, 7, low=1.1, high=4.0)]}, {}),
    "atanh": ("atanh", {"X": [_pos(3, 7, low=-0.9, high=0.9)]}, {}),
    "expm1": ("expm1", {"X": [_r(3, 7)]}, {}),
    "log1p": ("log1p", {"X": [_pos(3, 7, low=-0.8, high=3.0)]}, {}),
    "log2": ("log2", {"X": [_pos(3, 7)]}, {}),
    "log10": ("log10", {"X": [_pos(3, 7)]}, {}),
    "lgamma": ("lgamma", {"X": [_pos(3, 7, high=5.0)]}, {}),
    "digamma": ("digamma", {"X": [_pos(3, 7, high=5.0)]}, {}),
    "erfinv": ("erfinv", {"X": [_pos(3, 7, low=-0.9, high=0.9)]}, {}),
    "erfc": ("erfc", {"X": [_r(3, 7)]}, {}),
    "trunc": ("trunc", {"X": [3 * _r(3, 7)]}, {}),
    "frac": ("frac", {"X": [3 * _r(3, 7)]}, {}),
    "tanh_shrink": ("tanh_shrink", {"X": [2 * _r(3, 7)]}, {}),
    "mish": ("mish", {"X": [3 * _r(3, 7)]}, {}),
    "selu": ("selu", {"X": [2 * _r(3, 7)]}, {}),
    "elementwise_pow": ("elementwise_pow",
                        {"X": [_pos(2, 3, 4)], "Y": [_r(4, seed=1)]},
                        {"axis": -1}),
    "elementwise_pow-int32": ("elementwise_pow",
                              {"X": [_int32((3, 4), -3, 4)],
                               "Y": [_int32((3, 4), 0, 4, seed=2)]},
                              {"axis": -1}),
    "elementwise_max-axis1": ("elementwise_max",
                              {"X": [_r(2, 3, 4)], "Y": [_r(3, seed=1)]},
                              {"axis": 1}),
    "elementwise_max-int32": ("elementwise_max",
                              {"X": [_int32((3, 4), -5, 5)],
                               "Y": [_int32((3, 4), -5, 5, seed=2)]},
                              {"axis": -1}),
    "elementwise_min": ("elementwise_min",
                        {"X": [_r(2, 3, 4)], "Y": [_r(2, 3, 4, seed=1)]},
                        {"axis": -1}),
    "elementwise_min-axis0": ("elementwise_min",
                              {"X": [_r(2, 3, 4)], "Y": [_r(2, 3, seed=1)]},
                              {"axis": 0}),
    "elementwise_mod": ("elementwise_mod",
                        {"X": [3 * _r(3, 4)],
                         "Y": [_pos(3, 4, seed=1)
                               * np.sign(_r(3, 4, seed=2))]},
                        {"axis": -1}),
    "elementwise_mod-int32": ("elementwise_mod",
                              {"X": [_int32((3, 4), -9, 9)],
                               "Y": [_int32((3, 4), 1, 4, seed=2)
                                     * np.where(_r(3, 4) > 0, 1, -1)
                                     .astype(np.int32)]},
                              {"axis": -1}),
    "elementwise_floordiv": ("elementwise_floordiv",
                             {"X": [3 * _r(3, 4)],
                              "Y": [_pos(3, 4, seed=1)
                                    * np.sign(_r(3, 4, seed=2))]},
                             {"axis": -1}),
    "elementwise_floordiv-int32-axis1": (
        "elementwise_floordiv",
        {"X": [_int32((2, 3, 4), -9, 9)],
         "Y": [_int32((3,), 1, 4, seed=2) * np.array([1, -1, 1], np.int32)]},
        {"axis": 1}),
    "leaky_relu": ("leaky_relu", {"X": [_r(3, 7)]}, {"alpha": 0.1}),
    "elu": ("elu", {"X": [2 * _r(3, 7)]}, {"alpha": 0.7}),
    "hard_sigmoid": ("hard_sigmoid", {"X": [3 * _r(3, 7)]},
                     {"slope": 0.3, "offset": 0.4}),
    "swish": ("swish", {"X": [2 * _r(3, 7)]}, {"beta": 1.5}),
    "relu6": ("relu6", {"X": [2 * _r(3, 7)]}, {"threshold": 2.0}),
    "pow": ("pow", {"X": [_pos(3, 7)]}, {"factor": 2.5}),
    "clip": ("clip", {"X": [_r(3, 7)]}, {"min": -0.5, "max": 0.8}),
    "log_softmax": ("log_softmax", {"X": [3 * _r(2, 5, 3)]}, {"axis": 1}),
    "dot": ("dot", {"X": [_r(4, 6)], "Y": [_r(4, 6, seed=1)]}, {}),
    "logsumexp-tuple-keepdim": ("logsumexp", {"X": [3 * _r(2, 3, 4)]},
                                {"axis": [0, 2], "keepdim": True}),
    "logsumexp-all": ("logsumexp", {"X": [3 * _r(2, 3, 4)]},
                      {"axis": None, "keepdim": False}),
    "logsumexp-int-axis": ("logsumexp", {"X": [3 * _r(2, 3, 4)]},
                           {"axis": -1}),
    "roll-axes": ("roll", {"X": [_r(2, 3, 4)]},
                  {"shifts": [1, -2], "axis": [1, 2]}),
    "roll-flat": ("roll", {"X": [_r(2, 3, 4)]}, {"shifts": [5],
                                                 "axis": None}),
    "flip": ("flip", {"X": [_r(2, 3, 4)]}, {"axis": [0, 2]}),
    "broadcast_to": ("broadcast_to", {"X": [_r(3, 1)]},
                     {"shape": [2, 3, 4]}),
    "kldiv_loss-mean": ("kldiv_loss",
                        {"X": [np.log(_probs(4, 5))],
                         "Target": [_probs(4, 5, seed=1)]},
                        {"reduction": "mean"}),
    "kldiv_loss-sum": ("kldiv_loss",
                       {"X": [np.log(_probs(4, 5))],
                        "Target": [_probs(4, 5, seed=1)]},
                       {"reduction": "sum"}),
    "kldiv_loss-batchmean": ("kldiv_loss",
                             {"X": [np.log(_probs(4, 5))],
                              "Target": [_probs(4, 5, seed=1)]},
                             {"reduction": "batchmean"}),
    "kldiv_loss-none": ("kldiv_loss",
                        {"X": [np.log(_probs(4, 5))],
                         "Target": [_probs(4, 5, seed=1)]},
                        {"reduction": "none"}),
    "label_smooth": ("label_smooth", {"X": [_probs(4, 6)]},
                     {"epsilon": 0.2}),
    "label_smooth-prior": ("label_smooth",
                           {"X": [_probs(4, 6)],
                            "PriorDist": [_probs(1, 6, seed=1)]},
                           {"epsilon": 0.1}),
    "cos_sim": ("cos_sim", {"X": [_r(4, 6)], "Y": [_r(4, 6, seed=1)]}, {}),
    "cos_sim-broadcast-y": ("cos_sim", {"X": [_r(4, 6)],
                                        "Y": [_r(1, 6, seed=1)]}, {}),
    "instance_norm": ("instance_norm",
                      {"X": [2 * _r(2, 3, 4, 5) + 1],
                       "Scale": [_r(3, seed=1)], "Bias": [_r(3, seed=2)]},
                      {"epsilon": 1e-5}),
    "instance_norm-plain-n1": ("instance_norm", {"X": [_r(1, 3, 6)]},
                               {"epsilon": 1e-3}),
    "affine_grid-align": ("affine_grid", {"Theta": [_r(2, 2, 3)]},
                          {"output_shape": [2, 3, 4, 5],
                           "align_corners": True}),
    "affine_grid-centres": ("affine_grid", {"Theta": [_r(2, 2, 3)]},
                            {"output_shape": [2, 3, 4, 5],
                             "align_corners": False}),
    "grid_sampler-align": ("grid_sampler",
                           {"X": [_r(2, 3, 5, 6)],
                            "Grid": [_pos(2, 4, 3, 2, low=-1.2, high=1.2)]},
                           {"align_corners": True}),
    "grid_sampler-centres": ("grid_sampler",
                             {"X": [_r(2, 3, 5, 6)],
                              "Grid": [_pos(2, 4, 3, 2, low=-1.2,
                                            high=1.2)]},
                             {"align_corners": False}),
    "pixel_shuffle": ("pixel_shuffle", {"X": [_r(2, 8, 3, 3)]},
                      {"upscale_factor": 2}),
    "kron": ("kron", {"X": [_r(2, 3)], "Y": [_r(3, 2, seed=1)]}, {}),
    "einsum": ("einsum", {"Operands": [_r(3, 4), _r(4, 5, seed=1)]},
               {"equation": "ij,jk->ik"}),
    "einsum-batched": ("einsum", {"Operands": [_r(2, 3, 4),
                                               _r(2, 4, 5, seed=1)]},
                       {"equation": "bij,bjk->bik"}),
    "cholesky": ("cholesky", {"X": [_spd(4)]}, {"upper": False}),
    "cholesky-upper": ("cholesky", {"X": [_spd(4, seed=1)]},
                       {"upper": True}),
    "inverse": ("inverse", {"Input": [_tri(4)]}, {}),
    "matrix_power": ("matrix_power", {"X": [0.5 * _tri(3)]}, {"n": 3}),
    "matrix_power-negative": ("matrix_power", {"X": [_tri(3)]}, {"n": -2}),
    "triangular_solve-upper": ("triangular_solve",
                               {"X": [_tri(4)], "Y": [_r(4, 3, seed=1)]},
                               {"upper": True}),
    "triangular_solve-lower": ("triangular_solve",
                               {"X": [_tri(4)], "Y": [_r(4, 3, seed=1)]},
                               {"upper": False}),
    "triangular_solve-transpose": ("triangular_solve",
                                   {"X": [_tri(4)], "Y": [_r(4, 3, seed=1)]},
                                   {"upper": True, "transpose": True}),
    "triangular_solve-lower-transpose-unit": (
        "triangular_solve", {"X": [_tri(4)], "Y": [_r(4, 3, seed=1)]},
        {"upper": False, "transpose": True, "unitriangular": True}),
    "triangular_solve-unitriangular": ("triangular_solve",
                                       {"X": [_tri(4)],
                                        "Y": [_r(4, 3, seed=1)]},
                                       {"upper": True,
                                        "unitriangular": True}),
    "cross": ("cross", {"X": [_r(4, 3)], "Y": [_r(4, 3, seed=1)]},
              {"dim": None}),
    "cross-dim0": ("cross", {"X": [_r(3, 5)], "Y": [_r(3, 5, seed=1)]},
                   {"dim": 0}),
    "multi_dot": ("multi_dot", {"X": [_r(3, 4), _r(4, 5, seed=1),
                                      _r(5, 2, seed=2)]}, {}),
    "concat-axis1": ("concat", {"X": [_r(2, 3), _r(2, 1, seed=1),
                                      _r(2, 4, seed=2)]}, {"axis": 1}),
    "concat-axis0": ("concat", {"X": [_r(2, 3, 2), _r(1, 3, 2, seed=1)]},
                     {"axis": 0}),
    "cumsum": ("cumsum", {"X": [_r(3, 5)]}, {"axis": -1}),
    "cumsum-exclusive": ("cumsum", {"X": [_r(3, 5)]},
                         {"axis": 1, "exclusive": True}),
    "cumsum-reverse": ("cumsum", {"X": [_r(3, 5)]},
                       {"axis": 0, "reverse": True}),
    "cumsum-exclusive-reverse": ("cumsum", {"X": [_r(2, 3, 4)]},
                                 {"axis": 2, "exclusive": True,
                                  "reverse": True}),
    "cumsum-int32": ("cumsum", {"X": [_int32((3, 5), -5, 5)]},
                     {"axis": 1}),
    "reduce_max-dim": ("reduce_max", {"X": [_r(2, 3, 4)]},
                       {"dim": [1, 2], "keep_dim": False}),
    "reduce_max-all-int32": ("reduce_max", {"X": [_int32((3, 4), -9, 9)]},
                             {"reduce_all": True, "keep_dim": False}),
    "reduce_min-keep": ("reduce_min", {"X": [_r(2, 3, 4)]},
                        {"dim": [-1], "keep_dim": True}),
    "reduce_prod-dims": ("reduce_prod", {"X": [_pos(2, 3, 4, low=0.6,
                                                      high=1.5)]},
                         {"dim": [0, 2], "keep_dim": False}),
    "reduce_prod-all-keep": ("reduce_prod", {"X": [_pos(2, 3, low=-1.5,
                                                         high=1.5)]},
                             {"reduce_all": True, "keep_dim": True}),
    "reduce_prod-int32": ("reduce_prod", {"X": [_int32((3, 4), 1, 4)]},
                          {"dim": [1], "keep_dim": False}),
    "prelu-all": ("prelu", {"X": [_r(2, 3, 4, 4)], "Alpha": [_r(1, seed=1)]},
                  {"mode": "all"}),
    "prelu-channel": ("prelu", {"X": [_r(2, 3, 4, 4)],
                                "Alpha": [_r(3, seed=1)]},
                      {"mode": "channel"}),
    "prelu-element": ("prelu", {"X": [_r(2, 3, 4, 4)],
                                "Alpha": [_r(3, 4, 4, seed=1)]},
                      {"mode": "element"}),
}


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    from torch_static_common import jax_state_unchanged

    with jax_state_unchanged():
        yield


def _cotangents(outs):
    rng = np.random.RandomState(5)
    return {k: [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)) for o in v] for k, v in outs.items()}


@pytest.mark.parametrize("case", sorted(SURFACE))
def test_surface_case_lies_in_its_op_domain(case):
    from paddle_tpu_torch.fluid.core import registry

    op_type, ins, attrs = SURFACE[case]
    opdef = registry.get_op_def(op_type)
    tins = {k: [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
                for a in v] for k, v in ins.items()}
    outs = opdef.lower(registry.LowerContext(), tins, attrs)
    floats = [o for v in outs.values() for o in v if o.is_floating_point()]
    assert all(torch.isfinite(o).all() for o in floats), case
    leaves = [t for v in tins.values() for t in v if t.requires_grad]
    pairs = [(o, c) for k, v in outs.items()
             for o, c in zip(v, _cotangents(outs)[k]) if o.requires_grad]
    if leaves and pairs:
        grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [c for _, c in pairs], allow_unused=True)
        assert all(torch.isfinite(g).all() for g in grads if g is not None)
