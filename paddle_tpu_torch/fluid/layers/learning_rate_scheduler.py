"""Learning-rate schedules as in-program ops driven by a persistable step
counter.

Counterpart of `paddle_tpu/fluid/layers/learning_rate_scheduler.py`
(noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup, on
``_decay_step_counter``; cf. Paddle's layers/learning_rate_scheduler.py).
The startup program fills the f32 counter ``@LR_DECAY_COUNTER@`` with
``begin``; the main program increments it once a run, before the one
``lr_schedule`` op a schedule appends, whose non-persistable ``[1]``
output the static optimizers take as their learning rate.  The rate is
computed anew every run, before the update ops that read it.
"""

import math

import torch

from .. import framework
from ..core.registry import register_op
from .common import append_simple_op

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The persistable step counter, created at first use: its startup
    ``fill_constant`` and the main program's ``increment`` a run."""
    main = framework.default_main_program()
    startup = framework.default_startup_program()
    block = main.global_block
    if not block.has_var(_COUNTER_NAME):
        block.create_var(
            name=_COUNTER_NAME, shape=(1,), dtype="float32", persistable=True,
            stop_gradient=True,
        )
        sb = startup.global_block
        sb.create_var(name=_COUNTER_NAME, shape=(1,), dtype="float32",
                      persistable=True, stop_gradient=True)
        sb.append_op(
            "fill_constant",
            outputs={"Out": [_COUNTER_NAME]},
            attrs={"shape": [1], "value": float(begin), "dtype": "float32"},
            infer=False,
        )
        block.append_op(
            "increment",
            inputs={"X": [_COUNTER_NAME]},
            outputs={"Out": [_COUNTER_NAME]},
            attrs={"step": 1.0},
            infer=False,
        )
    return block.var(_COUNTER_NAME)


@register_op("lr_schedule", inputs=["Step"], outputs=["Out"], grad=None)
def _lr_schedule(ctx, ins, attrs):
    """The rate of schedule ``kind`` at the f32 step, in f32 (the
    reference's formulas, Python constants and all)."""
    step = ins["Step"][0][0]
    kind = attrs["kind"]
    a = attrs
    if kind == "noam":
        lr = a["d_model"] ** -0.5 * torch.minimum(
            (step + 1e-9) ** -0.5, (step + 1e-9) * a["warmup_steps"] ** -1.5
        ) * a.get("learning_rate", 1.0)
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        e = step / a["decay_steps"]
        if a["staircase"]:
            e = torch.floor(e)
        if kind == "exponential":
            lr = a["learning_rate"] * a["decay_rate"] ** e
        elif kind == "natural_exp":
            lr = a["learning_rate"] * torch.exp(-a["decay_rate"] * e)
        else:
            lr = a["learning_rate"] / (1.0 + a["decay_rate"] * e)
    elif kind == "polynomial":
        if a["cycle"]:
            ds = a["decay_steps"] * torch.clamp_min(
                torch.ceil(step / a["decay_steps"]), 1.0)
        else:
            ds = torch.full_like(step, a["decay_steps"])
        s = torch.minimum(step, ds)
        lr = (a["learning_rate"] - a["end_learning_rate"]) * (
            1 - s / ds
        ) ** a["power"] + a["end_learning_rate"]
    elif kind == "cosine":
        cur_epoch = torch.floor(step / a["step_each_epoch"])
        lr = (a["learning_rate"] * 0.5
              * (torch.cos(cur_epoch * math.pi / a["epochs"]) + 1))
    elif kind == "piecewise":
        boundaries = torch.tensor(a["boundaries"], dtype=torch.float32,
                                  device=step.device)
        values = torch.tensor(a["values"], dtype=torch.float32,
                              device=step.device)
        lr = values.index_select(0, (step >= boundaries).sum().reshape(1))
    elif kind == "warmup":
        frac = step / a["warmup_steps"]
        warm = a["start_lr"] + (a["end_lr"] - a["start_lr"]) * frac
        lr = torch.where(step < a["warmup_steps"], warm, a["main_lr"])
    else:
        raise ValueError("unknown lr schedule kind %s" % kind)
    return {"Out": [lr.to(torch.float32).reshape(1)]}


def _schedule(kind, **attrs):
    step = _decay_step_counter()
    attrs["kind"] = kind
    lr = append_simple_op("lr_schedule", {"Step": step}, attrs,
                          stop_gradient=True)
    lr.persistable = False
    return lr


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """d_model^-0.5 min(step^-0.5, step warmup_steps^-1.5) x
    learning_rate ("Attention Is All You Need" §5.3)."""
    return _schedule("noam", d_model=float(d_model),
                     warmup_steps=float(warmup_steps),
                     learning_rate=float(learning_rate))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("exponential", learning_rate=float(learning_rate),
                     decay_steps=float(decay_steps),
                     decay_rate=float(decay_rate), staircase=staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _schedule("natural_exp", learning_rate=float(learning_rate),
                     decay_steps=float(decay_steps),
                     decay_rate=float(decay_rate), staircase=staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _schedule("inverse_time", learning_rate=float(learning_rate),
                     decay_steps=float(decay_steps),
                     decay_rate=float(decay_rate), staircase=staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return _schedule("polynomial", learning_rate=float(learning_rate),
                     decay_steps=float(decay_steps),
                     end_learning_rate=float(end_learning_rate),
                     power=float(power), cycle=cycle)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _schedule("cosine", learning_rate=float(learning_rate),
                     step_each_epoch=float(step_each_epoch),
                     epochs=float(epochs))


def piecewise_decay(boundaries, values):
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay takes one value more than "
                         "boundaries, got %d and %d"
                         % (len(values), len(boundaries)))
    return _schedule("piecewise", boundaries=[float(b) for b in boundaries],
                     values=[float(v) for v in values])


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """From start_lr to end_lr over warmup_steps, then learning_rate: a
    float, or a schedule's Variable (then a ``less_than`` and a
    ``where`` pick between the two, as the reference builds it)."""
    if isinstance(learning_rate, float):
        return _schedule("warmup", warmup_steps=float(warmup_steps),
                         start_lr=float(start_lr), end_lr=float(end_lr),
                         main_lr=float(learning_rate))
    step = _decay_step_counter()
    from . import ops as _ops
    from . import tensor as _tensor

    frac = _ops.scale(step, scale=1.0 / warmup_steps)
    warm = _ops.scale(frac, scale=(end_lr - start_lr), bias=start_lr)
    cond = _tensor.less_than(
        step, _tensor.fill_constant([1], "float32", warmup_steps))
    return _tensor.where(cond, warm, learning_rate)
