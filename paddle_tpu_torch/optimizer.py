"""The reference's 13 optimizers: their update ops over lists of
parameters, the eager ``minimize`` path and the static one.

Counterpart of `paddle_tpu/fluid/optimizer.py` (the classes, their
constructor arguments and defaults, the dygraph ``minimize`` :220-257
and ``apply_gradients`` :174-218) and of the dense update ops of
`paddle_tpu/fluid/ops/optimizer_ops.py` (:20-391).  The reference's ops
are plain jnp, with no Pallas kernel, so plain PyTorch is their port.

The ops.  Each ``<op>_`` updates its lists in place, as the reference's
ops write ``ParamOut`` / ``...Out`` over their inputs: the parameters
and the state slots, all f32 (a parameter of another dtype is updated
through an f32 copy and written back).  Each step of a formula is one
multi-tensor (`torch._foreach_*`) call over the list, in the reference's
order of operations; what is per parameter (Adam's and LAMB's ``[1]``
beta powers, the per-tensor trust ratios of LAMB and LARS) runs per
parameter.  Per-tensor norms come from `torch._foreach_norm` and stay
on the device: no op reads a value back to the host.  ``<op>`` without
the underscore is the same op on copies, returning ``(params, *slots)``
as new lists.

Conventions that differ from `torch.optim`: Adam's beta-power
accumulators start at beta1 and beta2 (not at 1) and are multiplied by
beta after each update; ``lr_t = lr * sqrt(1 - beta2_pow) / (1 -
beta1_pow)`` and ``p -= lr_t * m1 / (sqrt(m2) + eps)`` with eps
unscaled; AdamW's decay ``- lr * coeff * p_old`` is decoupled, from the
parameter before this step's Adam update; Adadelta takes no learning
rate (its op has no ``LearningRate`` input); Adamax's beta1 power is
advanced by the optimizer after all its parameters' ops
(``_finish_update``, `fluid/optimizer.py:477-486`), not by the op.

The eager path: ``loss.backward(); opt.minimize(loss,
parameter_list=model.parameters())`` reads each parameter's ``.grad``,
skips those with none, clips the gradients (``grad_clip``, `clip`), adds
weight decay (``regularization``, `regularizer`; a parameter's own
``regularizer`` attribute wins), and runs the optimizer's op once over
all parameters, in place under ``no_grad``.  Accumulators are created
at first use on each parameter's device, keyed per parameter.  A
callable learning rate (a `learning_rate_scheduler` object) is advanced
and read once per ``minimize``.

The static path (`fluid/optimizer.py:38-278`): ``minimize(loss)`` on a
`fluid.framework.Variable` appends the backward (`fluid.backward
.append_backward`) and one update op a parameter to ``loss``'s program
(``op_role="optimize"``, the reference's op names, slots and attrs;
`fluid/ops/optimizer_ops.py` lowers them onto the list ops above).
The learning rate is a persistable ``[1]`` var and each accumulator a
persistable var named ``<param>_<accumulator>_<n>``, both filled by
``fill_constant`` ops in the default startup program, so
``save_persistables`` and resume carry them.  Adamax's beta1 power is
advanced by a ``scale`` op after its updates.  Static ``regularization``
and ``grad_clip`` raise (their ops come with ROADMAP Queue A 3 (b) 3).

`distributed.FunctionalOptimizer` runs the same ops over the train
step's state; it takes the five optimizers the reference's
``ShardedTrainStep`` adapts (SGD, Momentum, Adam, AdamW, LAMB).
"""

from __future__ import annotations

import torch

from .regularizer import append_regularization_ops

__all__ = [
    "AdadeltaOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamWOptimizer", "AdamaxOptimizer", "DecayedAdagradOptimizer",
    "DpsgdOptimizer", "FtrlOptimizer", "LambOptimizer",
    "LarsMomentumOptimizer", "MomentumOptimizer", "Optimizer",
    "RMSPropOptimizer", "SGDOptimizer",
    "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "DecayedAdagrad",
    "Dpsgd", "Ftrl", "Lamb", "LarsMomentum", "Momentum", "RMSProp", "SGD",
    "adadelta", "adagrad", "adam", "adamax", "adamw", "decayed_adagrad",
    "dpsgd", "ftrl", "lamb", "lars_momentum", "momentum", "rmsprop", "sgd",
    "adadelta_", "adagrad_", "adam_", "adamax_", "adamw_",
    "decayed_adagrad_", "dpsgd_", "ftrl_", "lamb_", "lars_momentum_",
    "momentum_", "rmsprop_", "sgd_",
]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# helpers of the list ops
# ---------------------------------------------------------------------------


def _one_minus(xs):
    """``1 - x`` for each tensor of ``xs`` (the same rounding: -x + 1)."""
    return torch._foreach_add(torch._foreach_neg(xs), 1.0)


def _f32(xs):
    return [x if x.dtype == _F32 else x.float() for x in xs]


def _store(p, pf):
    """Write the f32 working copies back into parameters of another
    dtype (f32 parameters were updated in place already)."""
    for x, y in zip(p, pf):
        if x is not y:
            x.copy_(y)


def _ema_(acc, decay, term):
    """``acc = decay * acc + (1 - decay) * term`` in place."""
    torch._foreach_mul_(acc, decay)
    torch._foreach_add_(acc, torch._foreach_mul(term, 1 - decay))


def _ema_sq_(acc, decay, g):
    """``acc = decay * acc + (1 - decay) * g * g`` in place."""
    t = torch._foreach_mul(g, 1 - decay)
    torch._foreach_mul_(t, g)
    torch._foreach_mul_(acc, decay)
    torch._foreach_add_(acc, t)


def _ratio_where_positive(num, den, coeff=None, extra=None):
    """Per tensor ``where(num > 0 & den > 0, [coeff *] num / (den
    [+ extra]), 1)`` over lists of 0-d norms, as one stacked tensor:
    LAMB's trust ratio and LARS's local learning rate."""
    a, b = torch.stack(num), torch.stack(den)
    top = a if coeff is None else a * coeff
    bot = b if extra is None else extra(a, b)
    return torch.where((a > 0) & (b > 0), top / bot, 1.0)


def _scale_each_(xs, scales):
    """``xs[i] *= scales[i]`` for a 1-D tensor of per-tensor scales."""
    torch._foreach_mul_(xs, list(scales.unbind()))


# ---------------------------------------------------------------------------
# the update ops, in place over lists (`fluid/ops/optimizer_ops.py`)
# ---------------------------------------------------------------------------


def sgd_(p, g, lr):
    """``p -= lr g`` (`optimizer_ops.py:26`), in the parameter's dtype."""
    torch._foreach_sub_(p, torch._foreach_mul([x.to(y.dtype) for x, y in
                                               zip(g, p)], lr))


def momentum_(p, g, lr, v, mu=0.9, use_nesterov=False):
    """``v = mu v + g``, then ``p -= lr v`` or, with Nesterov, ``p -= (g
    + mu v) lr`` with the new v (`optimizer_ops.py:31`)."""
    g = [x.float() for x in g]
    torch._foreach_mul_(v, mu)
    torch._foreach_add_(v, g)
    if use_nesterov:
        upd = torch._foreach_mul(v, mu)
        torch._foreach_add_(upd, g)
        torch._foreach_mul_(upd, lr)
    else:
        upd = torch._foreach_mul(v, lr)
    pf = _f32(p)
    torch._foreach_sub_(pf, upd)
    _store(p, pf)


def adam_(p, g, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """``m1 = beta1 m1 + (1 - beta1) g``, ``m2 = beta2 m2 + (1 - beta2) g
    g``, ``lr_t = lr sqrt(1 - b2p) / (1 - b1p)``, ``p -= lr_t m1 /
    (sqrt(m2) + eps)``, then ``b1p *= beta1``, ``b2p *= beta2``
    (`optimizer_ops.py:69`)."""
    g = [x.float() for x in g]
    _ema_(m1, beta1, g)
    _ema_sq_(m2, beta2, g)
    lr_t = torch._foreach_mul(torch._foreach_sqrt(_one_minus(b2p)), lr)
    torch._foreach_div_(lr_t, _one_minus(b1p))
    upd = [a * b for a, b in zip(lr_t, m1)]
    denom = torch._foreach_sqrt(m2)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_div_(upd, denom)
    del denom
    pf = _f32(p)
    torch._foreach_sub_(pf, upd)
    _store(p, pf)
    torch._foreach_mul_(b1p, beta1)
    torch._foreach_mul_(b2p, beta2)


def adamw_(p, g, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999, epsilon=1e-8,
           coeff=0.01):
    """`adam_`, then the decoupled decay ``- lr coeff p`` of each
    parameter as it was before the update (`optimizer_ops.py:116`)."""
    decay = torch._foreach_mul(_f32(p), lr * coeff)
    adam_(p, g, lr, m1, m2, b1p, b2p, beta1, beta2, epsilon)
    pf = _f32(p)
    torch._foreach_sub_(pf, decay)
    _store(p, pf)


def lamb_(p, g, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999, epsilon=1e-6,
          weight_decay=0.01):
    """Adam's moments, ``r = m1 / (1 - b1p) / (sqrt(m2 / (1 - b2p)) +
    eps) + wd p``, then ``p -= lr trust r`` with the per-tensor trust
    ratio ``‖p‖ / ‖r‖`` (1 where either norm is 0), then the beta powers
    (`optimizer_ops.py:130`)."""
    g = [x.float() for x in g]
    pf = _f32(p)
    _ema_(m1, beta1, g)
    _ema_sq_(m2, beta2, g)
    denom = [a / b for a, b in zip(m2, _one_minus(b2p))]
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, epsilon)
    r = [a / b for a, b in zip(m1, _one_minus(b1p))]
    torch._foreach_div_(r, denom)
    del denom
    torch._foreach_add_(r, torch._foreach_mul(pf, weight_decay))
    trust = _ratio_where_positive(torch._foreach_norm(pf),
                                  torch._foreach_norm(r))
    _scale_each_(r, trust * lr)
    torch._foreach_sub_(pf, r)
    _store(p, pf)
    torch._foreach_mul_(b1p, beta1)
    torch._foreach_mul_(b2p, beta2)


def adagrad_(p, g, lr, moment, epsilon=1e-6):
    """``m += g g``, ``p -= lr g / (sqrt(m) + eps)``
    (`optimizer_ops.py:168`)."""
    g = [x.float() for x in g]
    torch._foreach_add_(moment, torch._foreach_mul(g, g))
    _step_over_root_(p, g, lr, moment, epsilon)


def _step_over_root_(p, g, lr, acc, epsilon):
    """``p -= lr g / (sqrt(acc) + eps)``: Adagrad's and DecayedAdagrad's
    step."""
    upd = torch._foreach_mul(g, lr)
    denom = torch._foreach_sqrt(acc)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_div_(upd, denom)
    del denom
    pf = _f32(p)
    torch._foreach_sub_(pf, upd)
    _store(p, pf)


def adadelta_(p, g, lr, avg_sq_grad, avg_sq_update, rho=0.95, epsilon=1e-6):
    """``E[g²] = rho E[g²] + (1 - rho) g g``, ``u = -sqrt((E[u²] + eps) /
    (E[g²] + eps)) g``, ``E[u²] = rho E[u²] + (1 - rho) u u``, ``p +=
    u`` (`optimizer_ops.py:187`).  ``lr`` is taken and not used: the
    reference's op has no learning-rate input."""
    g = [x.float() for x in g]
    _ema_sq_(avg_sq_grad, rho, g)
    upd = torch._foreach_add(avg_sq_update, epsilon)
    torch._foreach_div_(upd, torch._foreach_add(avg_sq_grad, epsilon))
    torch._foreach_sqrt_(upd)
    torch._foreach_neg_(upd)
    torch._foreach_mul_(upd, g)
    _ema_sq_(avg_sq_update, rho, upd)
    pf = _f32(p)
    torch._foreach_add_(pf, upd)
    _store(p, pf)


def rmsprop_(p, g, lr, moment, mean_square, mean_grad, decay=0.95,
             epsilon=1e-6, momentum=0.0, centered=False):
    """``ms = rho ms + (1 - rho) g g``; centered: ``mg = rho mg + (1 -
    rho) g`` and ``denom = ms - mg mg + eps``, else ``ms + eps``; ``mom =
    momentum mom + lr g / sqrt(denom)``; ``p -= mom``
    (`optimizer_ops.py:210`)."""
    g = [x.float() for x in g]
    _ema_sq_(mean_square, decay, g)
    if centered:
        _ema_(mean_grad, decay, g)
        denom = torch._foreach_sub(mean_square,
                                   torch._foreach_mul(mean_grad, mean_grad))
        torch._foreach_add_(denom, epsilon)
    else:
        denom = torch._foreach_add(mean_square, epsilon)
    upd = torch._foreach_mul(g, lr)
    torch._foreach_div_(upd, torch._foreach_sqrt(denom))
    del denom
    torch._foreach_mul_(moment, momentum)
    torch._foreach_add_(moment, upd)
    pf = _f32(p)
    torch._foreach_sub_(pf, moment)
    _store(p, pf)


def adamax_(p, g, lr, moment, inf_norm, b1p, beta1=0.9, beta2=0.999,
            epsilon=1e-8):
    """``m = beta1 m + (1 - beta1) g``, ``u = max(beta2 u, |g|)``, ``p -=
    (lr / (1 - b1p)) (m / (u + eps))`` (`optimizer_ops.py:244`).  ``b1p``
    is read, not advanced: `AdamaxOptimizer` advances it after the op."""
    g = [x.float() for x in g]
    _ema_(moment, beta1, g)
    torch._foreach_mul_(inf_norm, beta2)
    torch._foreach_maximum_(inf_norm, torch._foreach_abs(g))
    upd = torch._foreach_div(moment, torch._foreach_add(inf_norm, epsilon))
    lr_t = [torch.full_like(b, lr) / b for b in _one_minus(b1p)]
    torch._foreach_mul_(upd, lr_t)
    pf = _f32(p)
    torch._foreach_sub_(pf, upd)
    _store(p, pf)


def decayed_adagrad_(p, g, lr, moment, decay=0.95, epsilon=1e-6):
    """``m = decay m + (1 - decay) g g``, ``p -= lr g / (sqrt(m) + eps)``
    (`optimizer_ops.py:268`)."""
    g = [x.float() for x in g]
    _ema_sq_(moment, decay, g)
    _step_over_root_(p, g, lr, moment, epsilon)


def ftrl_(p, g, lr, squared, linear, l1=0.0, l2=0.0, lr_power=-0.5):
    """FTRL-proximal (`optimizer_ops.py:288`): ``n' = n + g g``, ``sigma
    = (n'^-lr_power - n^-lr_power) / lr``, ``z += g - sigma p``, ``p =
    (sign(z) l1 - z) / (n'^-lr_power / lr + 2 l2)`` where ``|z| > l1``,
    else 0."""
    g = [x.float() for x in g]
    pf = _f32(p)
    old = torch._foreach_pow(squared, -lr_power)
    torch._foreach_add_(squared, torch._foreach_mul(g, g))
    y = torch._foreach_pow(squared, -lr_power)
    sigma = torch._foreach_sub(y, old)
    del old
    torch._foreach_div_(sigma, lr)
    torch._foreach_add_(linear, g)
    torch._foreach_sub_(linear, torch._foreach_mul(sigma, pf))
    del sigma
    torch._foreach_div_(y, lr)
    torch._foreach_add_(y, 2 * l2)
    for x, z, d in zip(pf, linear, y):
        x.copy_(torch.where(z.abs() > l1, (torch.sign(z) * l1 - z) / d, 0.0))
    _store(p, pf)


def lars_momentum_(p, g, lr, v, mu=0.9, lars_coeff=0.001,
                   lars_weight_decay=0.0005, epsilon=0.0):
    """LARS (`optimizer_ops.py:319`): the per-tensor local rate ``coeff
    ‖p‖ / (‖g‖ + wd ‖p‖ + eps)`` (1 where either norm is 0), ``v = mu v
    + lr local (g + wd p)``, ``p -= v``."""
    g = [x.float() for x in g]
    pf = _f32(p)
    local = _ratio_where_positive(
        torch._foreach_norm(pf), torch._foreach_norm(g), lars_coeff,
        lambda pn, gn: gn + lars_weight_decay * pn + epsilon)
    upd = torch._foreach_mul(pf, lars_weight_decay)
    torch._foreach_add_(upd, g)
    _scale_each_(upd, local * lr)
    torch._foreach_mul_(v, mu)
    torch._foreach_add_(v, upd)
    torch._foreach_sub_(pf, v)
    _store(p, pf)


def dpsgd_(p, g, lr, clip=10.0, batch_size=16.0, sigma=1.0, generator=None):
    """Differentially private SGD (`optimizer_ops.py:351`): each gradient
    scaled to norm at most ``clip``, Gaussian noise of std ``sigma clip``
    added (drawn from ``generator``, per parameter in list order), the
    sum divided by ``batch_size``, then ``p -= lr g_priv``."""
    g = [x.float() for x in g]
    norms = torch.stack(torch._foreach_norm(g))
    scale = torch.minimum(torch.ones_like(norms),
                          torch.full_like(norms, clip)
                          / torch.clamp_min(norms, 1e-10))
    upd = torch._foreach_mul(g, list(scale.unbind()))
    noise = [torch.randn(x.shape, generator=generator, dtype=_F32,
                         device=x.device) for x in g]
    torch._foreach_mul_(noise, sigma * clip)
    torch._foreach_add_(upd, noise)
    del noise
    torch._foreach_div_(upd, batch_size)
    torch._foreach_mul_(upd, lr)
    pf = _f32(p)
    torch._foreach_sub_(pf, upd)
    _store(p, pf)


def _functional(op_):
    def op(p, g, lr, *state, **attrs):
        p = [x.clone() for x in p]
        state = [[x.clone() for x in s] for s in state]
        op_(p, g, lr, *state, **attrs)
        return (p, *state)

    op.__name__ = op_.__name__[:-1]
    op.__doc__ = ("`%s` on copies: ``(params, *slots)``, new lists; the "
                  "inputs are left as they are." % op_.__name__)
    return op


sgd, momentum, adam, adamw, lamb, adagrad, adadelta, rmsprop, adamax = (
    _functional(f) for f in (sgd_, momentum_, adam_, adamw_, lamb_, adagrad_,
                             adadelta_, rmsprop_, adamax_))
decayed_adagrad, ftrl, lars_momentum, dpsgd = (
    _functional(f) for f in (decayed_adagrad_, ftrl_, lars_momentum_,
                             dpsgd_))


# ---------------------------------------------------------------------------
# the optimizers (`fluid/optimizer.py`)
# ---------------------------------------------------------------------------


class Optimizer:
    """The base of the 13: the learning rate, ``regularization``,
    ``grad_clip`` and the per-parameter accumulators, and the eager
    ``minimize`` / ``apply_gradients``.

    A subclass names its op (``op``, in place over lists) and its state
    slots (``slots``: ``(name, shape, fill)``, shape ``"param"`` for f32
    shaped and laid out like the parameter or ``"scalar"`` for ``[1]``
    f32, filled with ``fill``, a number or the name of an attribute), and
    gives the op's hyperparameters (``attrs()``)."""

    op = None
    slots = ()
    op_type = None      # the update op of a static program
    acc_names = ()      # its accumulators' names, one a slot

    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or type(self).__name__.lower()
        self._accumulators = {}     # parameter -> {slot: tensor}
        self._lr = None             # the learning rate of the next update
        self._lr_var = None         # static: the learning-rate var
        self._static_accs = {}      # static: name -> {param name: var}

    @property
    def learning_rate(self):
        return self._learning_rate

    def attrs(self):
        """The op's hyperparameters, as keyword arguments."""
        return {}

    # -- learning rate ---------------------------------------------------
    def current_step_lr(self):
        """The learning rate the next update uses: a scheduler's
        ``get_lr()`` until the first ``minimize`` advances it
        (`fluid/optimizer.py:_global_learning_rate`)."""
        if self._lr is None:
            lr = self._learning_rate
            if callable(lr):
                lr = lr.get_lr() if hasattr(lr, "get_lr") else lr()
            self._lr = float(lr)
        return self._lr

    def set_lr(self, value):
        """Set the learning rate of the next update (a scheduler still
        replaces it at the next ``minimize``)."""
        self._lr = float(value)

    # -- accumulators ----------------------------------------------------
    def init_slots(self, p):
        """``{slot: f32 tensor}`` of one parameter, on its device."""
        out = {}
        for slot, shape, fill in self.slots:
            value = float(getattr(self, fill) if isinstance(fill, str)
                          else fill)
            if shape == "param":
                out[slot] = torch.full_like(p, value, dtype=_F32)
            else:
                out[slot] = torch.full((1,), value, dtype=_F32,
                                       device=p.device)
        return out

    def _state_lists(self, params):
        """One list a slot over ``params``, each accumulator created at
        its parameter's first update."""
        acc = self._accumulators
        for p in params:
            if p not in acc:
                acc[p] = self.init_slots(p)
        return [[acc[p][slot] for p in params] for slot, _, _ in self.slots]

    def _finish_update(self, params, state):
        pass

    def _run(self, params, grads, lr, state):
        self.op(params, grads, lr, *state, **self.attrs())

    # -- the eager path --------------------------------------------------
    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """Clip the gradients, add weight decay, then update every
        parameter in place with one op over the lists
        (`fluid/optimizer.py:200-206`: clip first, regularize after).
        Returns the ``(param, grad)`` pairs as the op saw them.  Pairs
        of static vars append the update ops to their program
        instead."""
        params_grads = list(params_grads)
        if not params_grads:
            return params_grads
        if _is_static(params_grads[0][0]):
            return self._static_apply(params_grads)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        params = [p for p, _ in params_grads]
        state = self._state_lists(params)
        self._run(params, [g for _, g in params_grads],
                  self.current_step_lr(), state)
        self._finish_update(params, state)
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """The dygraph update after ``loss.backward()``: every parameter of
        ``parameter_list`` with a ``.grad`` is updated in place.  On a
        static ``loss`` var, the backward and the update ops are
        appended to its program instead (the static path).  Returns
        ``([], params_grads)``."""
        if _is_static(loss):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            self.apply_gradients(params_grads)
            return [], params_grads
        if parameter_list is None:
            raise ValueError(
                "dygraph minimize() requires parameter_list (cf. reference "
                "optimizer parameter_list requirement)")
        lr = self._learning_rate
        if callable(lr):
            self._lr = float(lr())
        params_grads = [(p, p.grad) for p in parameter_list
                        if p.grad is not None
                        and getattr(p, "trainable", True)]
        self.apply_gradients(params_grads)
        return [], params_grads

    # -- the static path (`fluid/optimizer.py:38-278`) --------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """`fluid.backward.append_backward` on a static ``loss``:
        ``[(param, grad var)]``."""
        from .fluid.backward import append_backward

        if self.regularization is not None or self._grad_clip is not None:
            raise NotImplementedError(
                "a static minimize with regularization or grad_clip needs "
                "the regularizer and clip ops, not ported yet (ROADMAP "
                "Queue A 3 (b) 3)")
        return append_backward(loss, parameter_list, no_grad_set)

    def _global_learning_rate(self):
        """The persistable ``[1]`` learning-rate var, created (with its
        startup ``fill_constant``) at first use; a static Variable passed
        as the learning rate is used as it is."""
        from .fluid import framework

        if self._lr_var is not None:
            return self._lr_var
        lr = self._learning_rate
        if isinstance(lr, framework.Variable):
            self._lr_var = lr
            return lr
        if callable(lr):
            raise TypeError(
                "a static program takes a float or a Variable learning "
                "rate, not %r" % (lr,))
        name = framework.unique_name.generate("learning_rate")
        self._lr_var = self._persistable(name, [1], float(lr))
        return self._lr_var

    @staticmethod
    def _persistable(name, shape, value, dtype="float32"):
        """A persistable var of the default main program, filled with
        ``value`` by a ``fill_constant`` op of the default startup
        program."""
        from .fluid import framework

        kw = dict(name=name, shape=shape, dtype=dtype, persistable=True,
                  stop_gradient=True)
        v = framework.default_main_program().global_block.create_var(**kw)
        sb = framework.default_startup_program().global_block
        sb.create_var(**kw)
        sb.append_op(
            "fill_constant", outputs={"Out": [name]},
            attrs={"shape": list(shape), "value": float(value),
                   "dtype": dtype},
            infer=False)
        return v

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None):
        from .fluid import framework

        accs = self._static_accs.setdefault(name, {})
        if param.name not in accs:
            accs[param.name] = self._persistable(
                framework.unique_name.generate(param.name + "_" + name),
                list(shape if shape is not None else param.shape),
                fill_value)
        return accs[param.name]

    def _static_apply(self, params_grads):
        """Accumulators for every parameter, then one update op a
        parameter, then `_static_finish_update`; the ops appended are
        tagged ``op_role="optimize"``."""
        from .fluid import framework
        from .fluid.ops.optimizer_ops import _UPDATES

        regularized = [p.name for p, _ in params_grads
                       if getattr(p, "regularizer", None) is not None]
        if regularized:
            raise NotImplementedError(
                "parameters with a regularizer (%s) need the regularizer "
                "ops, not ported yet (ROADMAP Queue A 3 (b) 3)" % regularized)
        block = framework.default_main_program().global_block
        first = len(block.ops)
        for p, _ in params_grads:
            for (_, shape, fill), acc in zip(self.slots, self.acc_names):
                self._add_accumulator(
                    acc, p, getattr(self, fill) if isinstance(fill, str)
                    else fill, None if shape == "param" else [1])
        _, _, out_of, has_lr = _UPDATES[self.op_type]
        for p, g in params_grads:
            inputs = {"Param": [p.name], "Grad": [g.name]}
            if has_lr:
                inputs["LearningRate"] = [self._global_learning_rate().name]
            outputs = {"ParamOut": [p.name]}
            for (slot, _, _), acc in zip(self.slots, self.acc_names):
                v = self._static_accs[acc][p.name].name
                inputs[slot] = [v]
                if slot in out_of:
                    outputs[out_of[slot]] = [v]
            block.append_op(self.op_type, inputs=inputs, outputs=outputs,
                            attrs=self.attrs(), infer=False)
        self._static_finish_update(block, params_grads)
        for op in block.ops[first:]:
            op.attrs.setdefault("op_role", "optimize")
        return params_grads

    def _static_finish_update(self, block, params_grads):
        pass


def _is_static(x):
    from .fluid import framework

    return isinstance(x, framework.Variable)


class SGDOptimizer(Optimizer):
    op = staticmethod(sgd_)
    op_type = "sgd"


class MomentumOptimizer(Optimizer):
    op = staticmethod(momentum_)
    slots = (("Velocity", "param", 0.0),)
    op_type, acc_names = "momentum", ("velocity",)

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = float(momentum)
        self.use_nesterov = bool(use_nesterov)

    def attrs(self):
        return {"mu": self.momentum, "use_nesterov": self.use_nesterov}


class LarsMomentumOptimizer(Optimizer):
    op = staticmethod(lars_momentum_)
    slots = (("Velocity", "param", 0.0),)
    op_type, acc_names = "lars_momentum", ("velocity",)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = float(momentum)
        self.lars_coeff = float(lars_coeff)
        self.lars_weight_decay = float(lars_weight_decay)

    def attrs(self):
        return {"mu": self.momentum, "lars_coeff": self.lars_coeff,
                "lars_weight_decay": self.lars_weight_decay}


class AdagradOptimizer(Optimizer):
    op = staticmethod(adagrad_)
    slots = (("Moment", "param", "initial_accumulator_value"),)
    op_type, acc_names = "adagrad", ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = float(epsilon)
        self.initial_accumulator_value = float(initial_accumulator_value)

    def attrs(self):
        return {"epsilon": self.epsilon}


class AdamOptimizer(Optimizer):
    op = staticmethod(adam_)
    slots = (("Moment1", "param", 0.0), ("Moment2", "param", 0.0),
             ("Beta1Pow", "scalar", "beta1"), ("Beta2Pow", "scalar", "beta2"))
    op_type = "adam"
    acc_names = ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
        self.lazy_mode = bool(lazy_mode)   # sparse updates only

    def attrs(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay ``coeff = weight_decay`` on every
    parameter (the ``adamw`` op)."""

    op = staticmethod(adamw_)
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self.weight_decay = float(weight_decay)

    def attrs(self):
        return dict(super().attrs(), coeff=self.weight_decay)


class LambOptimizer(AdamOptimizer):
    """Adam's moments with a per-tensor trust ratio (the ``lamb`` op,
    `fluid/optimizer.py:436-447`)."""

    op = staticmethod(lamb_)
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self.lamb_weight_decay = float(lamb_weight_decay)

    def attrs(self):
        return dict(super().attrs(), weight_decay=self.lamb_weight_decay)


class AdamaxOptimizer(Optimizer):
    op = staticmethod(adamax_)
    slots = (("Moment", "param", 0.0), ("InfNorm", "param", 0.0),
             ("Beta1Pow", "scalar", "beta1"))
    op_type = "adamax"
    acc_names = ("moment", "inf_norm", "beta1_pow_acc")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)

    def attrs(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}

    def _finish_update(self, params, state):
        # beta1_pow *= beta1 once a step, after every parameter's op
        torch._foreach_mul_(state[2], self.beta1)

    def _static_finish_update(self, block, params_grads):
        # the same through a scale op a parameter (`fluid/optimizer.py:477`)
        for p, _ in params_grads:
            b1p = self._static_accs["beta1_pow_acc"][p.name].name
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self.beta1}, infer=False)


class DecayedAdagradOptimizer(Optimizer):
    op = staticmethod(decayed_adagrad_)
    slots = (("Moment", "param", 0.0),)
    op_type, acc_names = "decayed_adagrad", ("moment",)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = float(decay), float(epsilon)

    def attrs(self):
        return {"decay": self.decay, "epsilon": self.epsilon}


class AdadeltaOptimizer(Optimizer):
    op = staticmethod(adadelta_)
    slots = (("AvgSquaredGrad", "param", 0.0),
             ("AvgSquaredUpdate", "param", 0.0))
    op_type = "adadelta"
    acc_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = float(epsilon), float(rho)

    def attrs(self):
        return {"rho": self.rho, "epsilon": self.epsilon}


class RMSPropOptimizer(Optimizer):
    op = staticmethod(rmsprop_)
    slots = (("Moment", "param", 0.0), ("MeanSquare", "param", 0.0),
             ("MeanGrad", "param", 0.0))
    op_type = "rmsprop"
    acc_names = ("momentum", "mean_square", "mean_grad")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = float(rho), float(epsilon)
        self.momentum, self.centered = float(momentum), bool(centered)

    def attrs(self):
        return {"decay": self.rho, "epsilon": self.epsilon,
                "momentum": self.momentum, "centered": self.centered}


class FtrlOptimizer(Optimizer):
    op = staticmethod(ftrl_)
    slots = (("SquaredAccumulator", "param", 0.0),
             ("LinearAccumulator", "param", 0.0))
    op_type, acc_names = "ftrl", ("squared", "linear")

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2 = float(l1), float(l2)
        self.lr_power = float(lr_power)

    def attrs(self):
        return {"l1": self.l1, "l2": self.l2, "lr_power": self.lr_power}


class DpsgdOptimizer(Optimizer):
    """DP-SGD.  The noise comes from a `torch.Generator` a device, seeded
    from ``seed`` (the reference draws from its tracer's key)."""

    op = staticmethod(dpsgd_)
    op_type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 seed=0, **kw):
        super().__init__(learning_rate, **kw)
        self.clip, self.batch_size = float(clip), float(batch_size)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self._generators = {}

    def attrs(self):
        return {"clip": self.clip, "batch_size": self.batch_size,
                "sigma": self.sigma}

    def _run(self, params, grads, lr, state):
        dev = params[0].device
        if dev not in self._generators:
            self._generators[dev] = torch.Generator(
                device=dev).manual_seed(self.seed)
        self.op(params, grads, lr, *state, generator=self._generators[dev],
                **self.attrs())


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
Dpsgd = DpsgdOptimizer
LarsMomentum = LarsMomentumOptimizer
