"""The 13 dense optimizer update ops (cf. paddle/fluid/operators/
optimizers/: sgd_op.cc, momentum_op.cc, adam_op.cc, lamb_op.cc, ...).

Counterpart of `paddle_tpu/fluid/ops/optimizer_ops.py:20-391`, with the
same op names, slots and attrs.  Each op lowers onto the list update
of `paddle_tpu_torch.optimizer` (``sgd_``, ``adamw_``, ...), so the
eager optimizers, the train step and the static programs share one copy
of each formula.  As in the reference, an op writes ``ParamOut`` and
its state outputs under the names of its inputs; here the update is in
place on those tensors (the scope's), run without autograd.

The Executor runs a stretch of consecutive update ops of one type and
one set of attrs as ONE call of the list update over all their
parameters (`run_group`): one multi-tensor launch a formula step instead
of one a parameter.  Each op touches only its own parameter and state,
so the values are those of the ops run one by one.
"""

import inspect

import torch

from ... import optimizer as _opt
from ..core.registry import get_op_def, register_op

_LR = "LearningRate"

# op type -> (list update, state input slots in the update's argument
# order, {state input slot: its output slot}, has a LearningRate input)
_UPDATES = {
    "sgd": (_opt.sgd_, (), {}, True),
    "momentum": (_opt.momentum_, ("Velocity",),
                 {"Velocity": "VelocityOut"}, True),
    "adam": (_opt.adam_, ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
             {"Moment1": "Moment1Out", "Moment2": "Moment2Out",
              "Beta1Pow": "Beta1PowOut", "Beta2Pow": "Beta2PowOut"}, True),
    "adagrad": (_opt.adagrad_, ("Moment",), {"Moment": "MomentOut"}, True),
    "adadelta": (_opt.adadelta_, ("AvgSquaredGrad", "AvgSquaredUpdate"),
                 {"AvgSquaredGrad": "AvgSquaredGradOut",
                  "AvgSquaredUpdate": "AvgSquaredUpdateOut"}, False),
    "rmsprop": (_opt.rmsprop_, ("Moment", "MeanSquare", "MeanGrad"),
                {"Moment": "MomentOut", "MeanSquare": "MeanSquareOut",
                 "MeanGrad": "MeanGradOut"}, True),
    "adamax": (_opt.adamax_, ("Moment", "InfNorm", "Beta1Pow"),
               {"Moment": "MomentOut", "InfNorm": "InfNormOut"}, True),
    "decayed_adagrad": (_opt.decayed_adagrad_, ("Moment",),
                        {"Moment": "MomentOut"}, True),
    "ftrl": (_opt.ftrl_, ("SquaredAccumulator", "LinearAccumulator"),
             {"SquaredAccumulator": "SquaredAccumOut",
              "LinearAccumulator": "LinearAccumOut"}, True),
    "lars_momentum": (_opt.lars_momentum_, ("Velocity",),
                      {"Velocity": "VelocityOut"}, True),
    "dpsgd": (_opt.dpsgd_, (), {}, True),
}
_UPDATES["adamw"] = (_opt.adamw_,) + _UPDATES["adam"][1:]
_UPDATES["lamb"] = (_opt.lamb_,) + _UPDATES["adam"][1:]


def _kwargs(fn):
    """The hyperparameter names ``fn`` takes (the ops' attr names)."""
    return frozenset(p.name for p in inspect.signature(fn).parameters.values()
                     if p.default is not inspect.Parameter.empty
                     and p.name != "generator")


_ATTRS = {t: _kwargs(u[0]) for t, u in _UPDATES.items()}


def run_group(op_type, ctx, ins_list, attrs):
    """Update ops ``op_type`` with ``attrs``, one ``ins`` dict each,
    as one list update: ``[outs]`` in the same order."""
    fn, state_slots, out_of, has_lr = _UPDATES[op_type]
    if has_lr and len({id(ins[_LR][0]) for ins in ins_list}) > 1:
        return [run_group(op_type, ctx, [ins], attrs)[0] for ins in ins_list]
    params = [ins["Param"][0] for ins in ins_list]
    outs = [{"ParamOut": [p]} for p in params]
    if ctx.is_meta:
        for ins, out in zip(ins_list, outs):
            out.update({out_of[s]: [ins[s][0]] for s in out_of})
        return outs
    lr = ins_list[0][_LR][0].reshape(()) if has_lr else None
    state = [[ins[s][0] for ins in ins_list] for s in state_slots]
    kw = {k: attrs[k] for k in _ATTRS[op_type] if k in attrs}
    if get_op_def(op_type).needs_rng:
        kw["generator"] = ctx.rng()
    with torch.no_grad():
        fn(params, [ins["Grad"][0] for ins in ins_list], lr, *state, **kw)
    for ins, out in zip(ins_list, outs):
        out.update({out_of[s]: [ins[s][0]] for s in out_of})
    return outs


def _register(op_type, needs_rng=False):
    _, state_slots, out_of, has_lr = _UPDATES[op_type]
    inputs = ["Param", "Grad"] + ([_LR] if has_lr else []) + list(state_slots)
    outputs = ["ParamOut"] + [out_of[s] for s in state_slots if s in out_of]

    @register_op(op_type, inputs=inputs, outputs=outputs, grad=None,
                 needs_rng=needs_rng)
    def _lower(ctx, ins, attrs):
        return run_group(op_type, ctx, [ins], attrs)[0]

    get_op_def(op_type).lower_group = (
        lambda ctx, ins_list, attrs: run_group(op_type, ctx, ins_list, attrs))


for _t in _UPDATES:
    _register(_t, needs_rng=_t == "dpsgd")
