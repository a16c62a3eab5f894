"""append_backward: reverse-mode AD by program rewriting.

Counterpart of `paddle_tpu/fluid/backward.py`, with the same program
rewrite: ``append_backward`` / ``gradients`` emit, for each op the
targets depend on, one generic ``vjp_grad`` op (or a custom maker's
ops: ``dropout_grad`` reuses the forward's mask), sum multi-consumer
partials with ``sum`` under ``<var>@GRAD@SUM`` and expose the total as
``<var>@GRAD`` through ``assign``, rename second sweeps ``@RENAME`` and
tag every emitted op ``op_role="backward"``.  A program built here
equals, dict for dict, the one the reference builds.

What differs is how ``vjp_grad`` runs.  The reference re-runs the
forward op's lowering under `jax.vjp` and lets XLA's CSE delete the
recomputation.  An eager interpreter has no CSE, so the Executor keeps
a tape (`core.block_eval.TapePlan`): each forward op a ``vjp_grad``
names runs once under autograd, on inputs detached from the rest of the
block, and the ``vjp_grad`` op calls `torch.autograd.grad` on the taped
outputs.  It recomputes the forward only where the tape lacks the op:
when it is itself differentiated by a later ``vjp_grad`` (double grad,
where it builds its graph with ``create_graph``) or when its forward op
is not in the block.
"""

from __future__ import annotations

import torch

from . import framework
from .core import dtypes as dtypes_mod
from .core.registry import get_op_def, register_op

# ---------------------------------------------------------------------------
# The generic VJP grad op
# ---------------------------------------------------------------------------
# Slot naming convention inside a vjp_grad op (the reference's):
#   inputs:  "X$<slot>"  forward inputs,  "DO$<slot>" output gradients
#   outputs: "DX$<slot>" input gradients
# attrs: fwd_type, fwd_attrs, fwd_in_slots (ordered), fwd_out_slots
#        (ordered, non-stateful), fwd_out_counts, out_grad_present,
#        grad_in_slots (the slots receiving gradients)


def _cotangents(ins, attrs, outs):
    """[(output, cotangent)] for the outputs with a gradient present that
    autograd can reach (floating, part of a graph)."""
    pairs = []
    for slot, present in zip(attrs["fwd_out_slots"],
                             attrs["out_grad_present"]):
        grads = iter(ins.get("DO$" + slot, []))
        for j, here in enumerate(present):
            if not here:
                continue
            g = next(grads)
            o = outs[slot][j]
            if o.requires_grad:
                pairs.append((o, g.to(o.dtype)))
    return pairs


# grad="auto": differentiating a vjp_grad op is how double grad works.
@register_op("vjp_grad", inputs=[], outputs=[], grad="auto")
def _vjp_grad(ctx, ins, attrs):
    grad_slots = attrs["grad_in_slots"]
    fwd_ins = {slot: list(ins.get("X$" + slot, []))
               for slot in attrs["fwd_in_slots"]}
    if ctx.is_meta:
        return {"DX$" + slot: [torch.empty_like(v) for v in fwd_ins[slot]]
                for slot in grad_slots}
    entry = ctx.tape_entry
    create_graph = torch.is_grad_enabled()
    if entry is not None:                 # the taped forward
        leaves, outs = entry
        primals = [t for slot in grad_slots for t in leaves[slot]]
    else:                                 # recompute, as the reference
        primals = []
        for slot in grad_slots:
            for i, t in enumerate(fwd_ins[slot]):
                if t.is_floating_point() and not t.requires_grad:
                    t = t.detach().requires_grad_()
                fwd_ins[slot][i] = t
                primals.append(t)
        with torch.enable_grad():
            outs = get_op_def(attrs["fwd_type"]).lower(
                ctx, fwd_ins, attrs["fwd_attrs"])
    pairs = _cotangents(ins, attrs, outs)
    wrt = [t for t in primals if t.requires_grad]
    grads = {}
    if pairs and wrt:
        grads = dict(zip(map(id, wrt), torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            retain_graph=ctx.retain_graph or create_graph,
            create_graph=create_graph, allow_unused=True)))
    out = {}
    for slot in grad_slots:
        src = leaves[slot] if entry is not None else fwd_ins[slot]
        out["DX$" + slot] = [
            torch.zeros_like(t) if grads.get(id(t)) is None else grads[id(t)]
            for t in src]
    return out


# ---------------------------------------------------------------------------
# Custom grad makers (ops whose grads can't come from plain VJP)
# ---------------------------------------------------------------------------

def _dropout_grad_maker(op, get_out_grad, new_grad_name, block):
    g = get_out_grad(op.output("Out")[0])
    if g is None:
        return []
    x = op.input("X")[0]
    gx = new_grad_name(x)
    return [
        (
            "dropout_grad",
            {"Mask": list(op.output("Mask")), "Out@GRAD": [g]},
            {"X@GRAD": [gx]},
            dict(op.attrs),
            {x: gx},
        )
    ]


def _lookup_table_grad_maker(op, get_out_grad, new_grad_name, block):
    """Dense tables (the default) fall through to the generic VJP (a
    dense ``[V, D]`` gradient).  ``is_sparse=True`` needs SelectedRows
    gradients and the sparse update ops, not ported yet."""
    if not op.attrs.get("is_sparse"):
        return None
    raise NotImplementedError(
        "lookup_table with is_sparse=True needs SelectedRows gradients and "
        "the sparse update ops, not ported yet (ROADMAP Queue A 3 (b) 3); "
        "set is_sparse=False")


CUSTOM_GRAD_MAKERS = {
    "dropout_grad_maker": _dropout_grad_maker,
    "lookup_table_grad_maker": _lookup_table_grad_maker,
}


# ---------------------------------------------------------------------------
# append_backward
# ---------------------------------------------------------------------------

def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Emit grad ops for `loss` into its program; return [(param, grad)].

    Matches reference `backward.py:1193` semantics: honors stop_gradient and
    no_grad_set, sums multi-consumer gradients, names grads `<var>@GRAD`.
    """
    return _append_backward_for_targets(
        [loss], [None], parameter_list=parameter_list, no_grad_set=no_grad_set
    )


def _append_backward_for_targets(
    targets, target_gradients, parameter_list=None, no_grad_set=None,
    return_map=False,
):
    """Shared engine behind append_backward / gradients (reference
    `backward.py:1601` calc_gradient): seeds each target with the provided
    output gradient (or ones), then runs one reverse sweep."""
    loss = targets[0]
    block = loss.block
    for t in targets[1:]:
        if t.block is not block:
            raise ValueError(
                "backward targets span different blocks: %r vs %r — "
                "compute gradients per block" % (loss.name, t.name))
    for tg in (target_gradients or []):
        if tg is not None and tg.block is not block:
            raise ValueError(
                "target_gradient %r lives in a different block than the "
                "targets" % tg.name)
    no_grad = set(no_grad_set or ())
    first_backward_op_idx = len(block.ops)

    # 1. ops relevant to the targets (backward data-flow reachability),
    #    in reverse program order
    needed = {t.name for t in targets}
    relevant = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.all_output_names()):
            relevant.append(op)
            needed.update(op.all_input_names())

    # 2. partial-grad bookkeeping
    partials: dict[str, list[str]] = {}

    def new_grad_name(var_name):
        lst = partials.setdefault(var_name, [])
        base = framework.grad_var_name(var_name)
        # a fresh name when the canonical one is taken (second sweep for
        # double grad, or multiple partials): SSA, never redefine a var
        if not lst and not block.has_var(base):
            name = base
        else:
            name = framework.unique_name.generate(base + "@RENAME")
        lst.append(name)
        v = block._find_var_recursive(var_name)
        # grad vars stay differentiable so a second sweep can chain
        # through them
        block.create_var(
            name=name, shape=v.shape, dtype=v.dtype, stop_gradient=False
        )
        return name

    def get_total_grad(var_name):
        lst = partials.get(var_name, [])
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        total = framework.grad_var_name(var_name) + "@SUM"
        if block.has_var(total):  # a previous sweep already used this name
            total = framework.unique_name.generate(total)
        v = block._find_var_recursive(var_name)
        block.create_var(name=total, shape=v.shape, dtype=v.dtype,
                         stop_gradient=False)
        block.append_op(
            "sum", inputs={"X": list(lst)}, outputs={"Out": [total]},
            infer=False
        )
        partials[var_name] = [total]
        return total

    # 3. seed each target: provided output grad, else d target/d target = 1
    for t, tg in zip(targets, target_gradients):
        if tg is not None:
            if tuple(tg.shape) != tuple(t.shape):
                raise ValueError(
                    "target_gradient %s shape %s does not match target %s "
                    "shape %s" % (tg.name, tg.shape, t.name, t.shape)
                )
            partials.setdefault(t.name, []).append(tg.name)
            continue
        t_grad = framework.grad_var_name(t.name)
        if not block.has_var(t_grad):
            block.create_var(
                name=t_grad, shape=t.shape, dtype=t.dtype, stop_gradient=True
            )
        block.append_op(
            "fill_constant",
            inputs={},
            outputs={"Out": [t_grad]},
            attrs={"shape": list(t.shape), "value": 1.0, "dtype": t.dtype},
            infer=False,
        )
        partials.setdefault(t.name, []).append(t_grad)

    def wants_grad(var_name, slot, opdef):
        if slot in opdef.no_grad_slots or var_name in no_grad:
            return False
        v = block._find_var_recursive(var_name)
        if v is None or v.stop_gradient:
            return False
        return dtypes_mod.is_floating(v.dtype)

    # 4. reverse sweep
    for op in relevant:
        opdef = get_op_def(op.type)
        if opdef.grad_maker is None:
            continue

        # custom maker?  (returning None falls through to the generic path)
        if opdef.grad_maker != "auto":
            maker = CUSTOM_GRAD_MAKERS[opdef.grad_maker]
            specs = maker(op, get_total_grad, new_grad_name, block)
            if specs is not None:
                for type_, ins_, outs_, attrs_, _gradmap in specs:
                    block.append_op(type_, inputs=ins_, outputs=outs_,
                                    attrs=attrs_, infer=False)
                continue

        # generic vjp path
        grad_in_slots = [
            slot for slot, names in op.inputs.items()
            if any(wants_grad(n, slot, opdef) for n in names)]
        if not grad_in_slots:
            continue

        out_slots = [s for s in op.outputs
                     if s not in opdef.stateful_out_slots]
        out_counts = [len(op.outputs[s]) for s in out_slots]
        out_grad_present = []
        do_inputs = {}
        any_grad = False
        for slot in out_slots:
            present = []
            slot_grads = []
            for name in op.outputs[slot]:
                g = get_total_grad(name)
                present.append(g is not None)
                if g is not None:
                    slot_grads.append(g)
                    any_grad = True
            out_grad_present.append(present)
            if slot_grads:
                do_inputs["DO$" + slot] = slot_grads
        if not any_grad:
            continue

        vjp_inputs = {"X$" + slot: list(op.inputs[slot])
                      for slot in op.inputs}
        vjp_inputs.update(do_inputs)
        vjp_outputs = {}
        for slot in grad_in_slots:
            gnames = []
            for n in op.inputs[slot]:
                if wants_grad(n, slot, opdef):
                    gnames.append(new_grad_name(n))
                else:
                    # vjp still returns a cotangent for every entry in the
                    # slot; route unwanted ones to throwaway vars
                    v = block._find_var_recursive(n)
                    junk = framework.unique_name.generate(n + "@GRAD@JUNK")
                    block.create_var(name=junk, shape=v.shape, dtype=v.dtype,
                                     stop_gradient=True)
                    gnames.append(junk)
            vjp_outputs["DX$" + slot] = gnames

        block.append_op(
            "vjp_grad",
            inputs=vjp_inputs,
            outputs=vjp_outputs,
            attrs={
                "fwd_type": op.type,
                "fwd_attrs": dict(op.attrs),
                "fwd_in_slots": list(op.inputs),
                "fwd_out_slots": out_slots,
                "fwd_out_counts": out_counts,
                "out_grad_present": out_grad_present,
                "grad_in_slots": grad_in_slots,
            },
            infer=False,
        )

    # 5. sum any remaining multi-partial leaf grads so `<var>@GRAD` is total
    #    (cf. reference _addup_repetitive_outputs_).  Skipped for the
    #    calc_gradient path (return_map): redefining the canonical name would
    #    clobber an earlier sweep's grads under double grad.
    for var_name in [] if return_map else list(partials):
        if len(partials[var_name]) > 1:
            total = get_total_grad(var_name)
            canonical = framework.grad_var_name(var_name)
            if total != canonical:
                v = block._find_var_recursive(var_name)
                if not block.has_var(canonical):
                    block.create_var(name=canonical, shape=v.shape,
                                     dtype=v.dtype, stop_gradient=True)
                block.append_op(
                    "assign",
                    inputs={"X": [total]},
                    outputs={"Out": [canonical]},
                    infer=False,
                )
                partials[var_name] = [canonical]

    # tag everything emitted here for clone(for_test) pruning (cf. OpRole)
    for op in block.ops[first_backward_op_idx:]:
        op.attrs.setdefault("op_role", "backward")

    if return_map:
        gmap = {name: get_total_grad(name) for name in list(partials)}
        # tag the sum ops get_total_grad just emitted, too
        for op in block.ops[first_backward_op_idx:]:
            op.attrs.setdefault("op_role", "backward")
        return gmap

    # 6. collect (param, grad) pairs
    if parameter_list is not None:
        params = [
            block.var(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    result = []
    for p in params:
        g = get_total_grad(p.name)
        if g is None:
            continue
        result.append((p, block.var(g)))
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """cf. reference backward.py:1727 / calc_gradient:1601 — grads of
    (possibly several) targets w.r.t. inputs, with optional provided output
    gradients.  Calling it on the result of a previous call yields
    double grad (the emitted vjp_grad ops are themselves differentiable).
    """
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    if not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(
            "gradients(): %d targets but %d target_gradients"
            % (len(targets), len(target_gradients))
        )
    block = targets[0].block
    grad_map = _append_backward_for_targets(
        list(targets), list(target_gradients),
        parameter_list=[], no_grad_set=no_grad_set,
        return_map=True,
    )
    out = []
    for iv in inputs:
        gname = grad_map.get(iv.name)
        out.append(block.var(gname) if gname is not None else None)
    return out
