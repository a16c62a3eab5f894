"""Uniform walkers over the Program op graph — real Operators AND the
serialized sub-block op dicts control flow / recompute fold into attrs.

Capability parity: the reference's `framework/ir/graph.h` builds an explicit
node graph from a ProgramDesc before passes/analyses run over it.  The JSON
IR keeps ops in two shapes — `framework.Operator` objects in `block.ops` and
plain dicts inside attrs like ``true_ops`` (cond), ``body_ops`` (while),
``step_ops`` (static_rnn) and ``ops`` (recompute_segment) — so every
whole-program analysis needs one canonical way to see both.  These helpers
are duck-typed over that union: nothing here imports framework, so the
module is import-cycle-free and works on deserialized programs too.
"""

from __future__ import annotations

# attr keys that hold serialized sub-block op lists (control_flow.py,
# optimizer.py RecomputeOptimizer; keep in sync with executor._has_print
# and fleet._rewrite_batch_norm_ops)
SUB_OP_ATTRS = (
    "ops", "true_ops", "false_ops", "cond_ops", "body_ops", "step_ops",
)

# ops whose deletion changes observable behavior even when their outputs
# are dead (host I/O, cross-rank communication); "c_" prefixed collectives
# are covered by prefix so new collectives stay protected by default
SIDE_EFFECT_OP_TYPES = {
    "print", "assert", "py_func", "save", "load", "send", "recv",
}


def op_type(op):
    return op["type"] if isinstance(op, dict) else op.type


def op_inputs(op):
    return op["inputs"] if isinstance(op, dict) else op.inputs


def op_outputs(op):
    return op["outputs"] if isinstance(op, dict) else op.outputs


def op_attrs(op):
    return op["attrs"] if isinstance(op, dict) else op.attrs


def input_names(op):
    return [n for ns in op_inputs(op).values() for n in ns]


def output_names(op):
    return [n for ns in op_outputs(op).values() for n in ns]


def iter_sub_ops(op):
    """Yield every serialized sub-op dict nested (recursively) under `op`."""
    for key in SUB_OP_ATTRS:
        sub = op_attrs(op).get(key)
        if isinstance(sub, list):
            for sop in sub:
                if isinstance(sop, dict) and "type" in sop:
                    yield sop
                    yield from iter_sub_ops(sop)


def iter_all_ops(program):
    """Yield (block_idx, op_idx, op) over every real Operator in the
    program — every block, not just the current one."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            yield block.idx, i, op


def iter_all_ops_deep(program):
    """iter_all_ops plus the serialized sub-op dicts each op carries."""
    for bidx, oidx, op in iter_all_ops(program):
        yield bidx, oidx, op
        for sop in iter_sub_ops(op):
            yield bidx, oidx, sop


def attr_name_lists(op):
    """Name-list attrs: every attr whose value is a non-empty list of
    strings (cap_names, var_names, in/out_names, branch out lists, ...).
    These bind sub-block aliases to values at lowering time, so the names
    in them are live/referenced even though no op lists them as a slot."""
    out = []
    for key, val in op_attrs(op).items():
        if key in SUB_OP_ATTRS or key == "op_callstack":
            continue
        if (isinstance(val, list) and val
                and all(isinstance(x, str) for x in val)):
            out.append((key, val))
    return out


def has_side_effects(op):
    """True when the op — or any serialized sub-op nested in it — performs
    host I/O or cross-rank communication (a cond whose branch prints must
    survive dead-code elimination even if its outputs are unused)."""
    t = op_type(op)
    if t in SIDE_EFFECT_OP_TYPES or t.startswith("c_"):
        return True
    return any(has_side_effects(sop) for sop in iter_sub_ops(op))


def referenced_names(program):
    """Every var name mentioned anywhere in the program: op inputs, op
    outputs, serialized sub-op slots, and name-list attrs.  The complement
    of this set over `block.vars` is the orphan set."""
    names = set()
    for _b, _i, op in iter_all_ops_deep(program):
        names.update(input_names(op))
        names.update(output_names(op))
        for _k, vals in attr_name_lists(op):
            names.update(vals)
    return names


def producers(program):
    """name -> list of (block_idx, op_idx) of real ops producing it."""
    out = {}
    for bidx, oidx, op in iter_all_ops(program):
        for n in output_names(op):
            out.setdefault(n, []).append((bidx, oidx))
    return out


def producer_before(block, name, before_idx):
    """Latest real op in `block` producing `name` strictly before index
    `before_idx`, as (op_idx, op); None when the var comes from outside
    the block (feed, param, parent block)."""
    for i in range(min(before_idx, len(block.ops)) - 1, -1, -1):
        if name in output_names(block.ops[i]):
            return i, block.ops[i]
    return None


def op_provenance(op):
    """The op_callstack frames recorded by append_op provenance capture
    (innermost user frame first), [] when capture was off.  Works on
    Operators and serialized sub-op dicts alike."""
    return list(op_attrs(op).get("op_callstack") or [])


def drop_orphan_vars(program, keep=(), candidates=None):
    """Delete var-table entries nothing references: the shared hygiene
    sweep behind DeadOpEliminationPass, BatchNormActFusePass, and
    Program.clone(for_test=True).  Exemptions mirror the verifier's
    orphan-var rule (persistable/feed vars and selected_rows marker vars
    stay), so a pass using this sweep always verifies orphan-clean.
    `candidates` limits the sweep to those names (a surgical pass drops
    only the vars IT stranded, not every orphan in the program).
    Returns the dropped names."""
    keep = set(keep)
    cand = None if candidates is None else set(candidates)
    referenced = referenced_names(program)
    dropped = []
    for block in program.blocks:
        for name in [n for n, v in block.vars.items()
                     if (cand is None or n in cand)
                     and n not in referenced and n not in keep
                     and not v.persistable and not v.is_data
                     and not getattr(v, "selected_rows", None)]:
            del block.vars[name]
            dropped.append(name)
    return dropped
