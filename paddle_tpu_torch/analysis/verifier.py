"""ProgramVerifier: whole-program structural invariants + shape re-inference.

The port's own copy of `paddle_tpu/analysis/verifier.py`, over the
port's Program IR and op registry; shape re-inference runs each op's
PyTorch lowering on meta tensors where the reference runs
`jax.eval_shape`.

Capability parity: the reference validates programs statically before
execution — `OpDesc::CheckAttrs`, per-op `InferShape`/`InferVarType` at
build time, and `framework/ir/`'s graph sanity checks.  This framework's IR
only checks each op in isolation when it is appended
(`fluid/framework.py:_infer_op`); a broken pass, a hand-edited program, or
a corrupted serialized model otherwise surfaces as an opaque error deep
inside `Executor.run`.  The verifier replays the global
invariants over a finished Program so the failure is caught at the
boundary that caused it, with a structured diagnostic naming the op/var.

Invariants (each yields a distinct diagnostic `code`):
  * ``unknown-op``          — op type not resolvable via the registry
  * ``dangling-input``      — op input resolves to no Variable anywhere
  * ``dangling-output``     — op output has no Variable entry
  * ``def-before-use``      — op reads a var produced only by a LATER op
                              (or by no op at all, and it is neither a
                              feed, persistable, nor a sub-block alias)
  * ``duplicate-definition``— two ops in one block define the same
                              non-persistable var (the IR is SSA for
                              temporaries; state rebinding is exempt)
  * ``bad-block-link``      — block idx/parent chain broken or cyclic
  * ``bad-sub-block``       — a ``sub_block*`` attr names a bad block
  * ``missing-fetch``       — a requested fetch target has no Variable or
                              no producer (checked when fetch_names given)
  * ``shape-mismatch`` / ``dtype-mismatch`` / ``missing-out-slot`` /
    ``out-arity-mismatch`` /
    ``shape-inference-failed`` — whole-program re-inference (replaying
    every op's lowering on meta tensors with the -1 sentinel convention)
    disagrees with the recorded var metadata
  * ``orphan-var``          — (opt-in, `check_orphans=True`; the
    post-pass safety net) a block.vars entry nothing references
"""

from __future__ import annotations

from . import opgraph
from .diagnostics import (
    ERROR, WARNING, Diagnostics, ProgramVerificationError,
)


_provenance = opgraph.op_provenance


class ProgramVerifier:
    """Structural + shape verification over a whole Program.

    check_shapes: replay shape/dtype inference over every op (slower —
      one meta-tensor lowering per op, same cost as building the program).
    check_orphans: treat unreferenced block.vars entries as findings
      (WARNING) — used by `ir.apply_passes(verify=True)` so a pass that
      strands a var (the historical BatchNormActFusePass bug) fails loudly.
    """

    def __init__(self, check_shapes=True, check_orphans=False):
        self.check_shapes = check_shapes
        self.check_orphans = check_orphans

    # ------------------------------------------------------------------
    def verify(self, program, feed_names=None, fetch_names=None):
        diags = Diagnostics()
        if not self._check_block_links(program, diags):
            # block graph is broken: var resolution via parent links is
            # undefined, later checks would crash or mislead
            return diags
        self._check_op_types(program, diags)
        self._check_var_references(program, diags)
        self._check_def_before_use(program, diags, feed_names or ())
        self._check_duplicate_defs(program, diags)
        self._check_sub_block_attrs(program, diags)
        if fetch_names:
            self._check_fetch_targets(program, diags, fetch_names)
        if self.check_shapes:
            self._check_shapes(program, diags)
        if self.check_orphans:
            self._check_orphans(program, diags)
        return diags

    # -- block graph ---------------------------------------------------
    def _check_block_links(self, program, diags):
        ok = True
        for pos, block in enumerate(program.blocks):
            if block.idx != pos:
                diags.add(ERROR, "bad-block-link",
                          "block at position %d carries idx %d"
                          % (pos, block.idx), block_idx=pos)
                ok = False
            parent = block.parent_idx
            if pos == 0:
                if parent != -1:
                    diags.add(ERROR, "bad-block-link",
                              "root block 0 has parent_idx %d (expected -1)"
                              % parent, block_idx=0)
                    ok = False
            elif not (0 <= parent < len(program.blocks)) or parent >= pos:
                # parents must come earlier in the list: guarantees the
                # parent chain terminates (no cycles)
                diags.add(ERROR, "bad-block-link",
                          "block %d has invalid parent_idx %d"
                          % (pos, parent), block_idx=pos)
                ok = False
        return ok

    # -- registry ------------------------------------------------------
    def _check_op_types(self, program, diags):
        from ..fluid.core.registry import has_op

        for bidx, oidx, op in opgraph.iter_all_ops_deep(program):
            t = opgraph.op_type(op)
            if not has_op(t):
                diags.add(ERROR, "unknown-op",
                          "op type %r is not in the operator registry" % t,
                          block_idx=bidx, op_idx=oidx, op_type=t,
                          provenance=_provenance(op))

    # -- var references ------------------------------------------------
    def _check_var_references(self, program, diags):
        for bidx, oidx, op in opgraph.iter_all_ops(program):
            block = program.blocks[bidx]
            for n in op.all_input_names():
                if block._find_var_recursive(n) is None:
                    diags.add(ERROR, "dangling-input",
                              "op %r reads var %r which has no Variable in "
                              "block %d or its ancestors"
                              % (op.type, n, bidx),
                              block_idx=bidx, op_idx=oidx, op_type=op.type,
                              var_names=[n], provenance=_provenance(op))
            for n in op.all_output_names():
                if block._find_var_recursive(n) is None:
                    diags.add(ERROR, "dangling-output",
                              "op %r writes var %r which has no Variable in "
                              "block %d or its ancestors"
                              % (op.type, n, bidx),
                              block_idx=bidx, op_idx=oidx, op_type=op.type,
                              var_names=[n], provenance=_provenance(op))

    # -- def-before-use ------------------------------------------------
    def _bound_alias_names(self, program):
        """Names bound at lowering time via name-list attrs (sub-block
        aliases like cond cap_names / while var_names / static_rnn slots,
        recompute in/out_names) — producer-less by design."""
        bound = set()
        for _b, _i, op in opgraph.iter_all_ops_deep(program):
            for _k, vals in opgraph.attr_name_lists(op):
                bound.update(vals)
        return bound

    def _check_def_before_use(self, program, diags, feed_names):
        feed_names = set(feed_names)
        bound = self._bound_alias_names(program)
        producers = opgraph.producers(program)
        for block in program.blocks:
            defined = set()
            ancestors = set()
            b = block
            while b.parent_idx >= 0:
                b = program.blocks[b.parent_idx]
                ancestors.update(b.vars)
            for oidx, op in enumerate(block.ops):
                for n in op.all_input_names():
                    if n in defined or n in feed_names or n in bound:
                        continue
                    v = block._find_var_recursive(n)
                    if v is None:
                        continue  # dangling-input already reported
                    if v.persistable or v.is_data:
                        continue
                    if getattr(v, "selected_rows", None):
                        continue  # sparse-grad marker: no dense producer
                    later_here = any(
                        pb == block.idx and po > oidx
                        for pb, po in producers.get(n, ())
                    )
                    if later_here:
                        diags.add(
                            ERROR, "def-before-use",
                            "op %r reads %r before the op that produces it "
                            "(produced at op %d of block %d)"
                            % (op.type, n,
                               max(po for pb, po in producers[n]
                                   if pb == block.idx), block.idx),
                            block_idx=block.idx, op_idx=oidx,
                            op_type=op.type, var_names=[n],
                            provenance=_provenance(op))
                    elif n not in producers and n not in ancestors:
                        diags.add(
                            ERROR, "def-before-use",
                            "op %r reads %r which no op produces and which "
                            "is neither a feed, persistable, nor a "
                            "sub-block alias" % (op.type, n),
                            block_idx=block.idx, op_idx=oidx,
                            op_type=op.type, var_names=[n],
                            provenance=_provenance(op))
                defined.update(op.all_output_names())

    # -- SSA for temporaries -------------------------------------------
    def _check_duplicate_defs(self, program, diags):
        for block in program.blocks:
            seen = {}
            for oidx, op in enumerate(block.ops):
                for n in op.all_output_names():
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable:
                        continue  # state rebinding is sequential, not SSA
                    if n in seen:
                        diags.add(
                            ERROR, "duplicate-definition",
                            "non-persistable var %r defined by op %d (%s) "
                            "and again by op %d (%s) in block %d"
                            % (n, seen[n][0], seen[n][1], oidx, op.type,
                               block.idx),
                            block_idx=block.idx, op_idx=oidx,
                            op_type=op.type, var_names=[n],
                            provenance=_provenance(op))
                    else:
                        seen[n] = (oidx, op.type)

    # -- fetch targets -------------------------------------------------
    def _check_fetch_targets(self, program, diags, fetch_names):
        """Every fetch target must have a Variable entry and a value
        source — an op (real or serialized sub-op) producing it, a
        name-list attr binding it, or persistable/feed status.  Catches
        mistyped fetch names and targets whose producer a prune or pass
        deleted: the broken-export case the save/load gates exist to
        stop."""
        bound = self._bound_alias_names(program)
        produced = set()
        for _b, _i, op in opgraph.iter_all_ops_deep(program):
            produced.update(opgraph.output_names(op))
        for n in fetch_names:
            v = None
            for block in program.blocks:
                if n in block.vars:
                    v = block.vars[n]
                    break
            if v is None:
                diags.add(ERROR, "missing-fetch",
                          "fetch target %r has no Variable anywhere in "
                          "the program" % n, var_names=[n])
            elif (n not in produced and n not in bound
                  and not v.persistable and not v.is_data):
                diags.add(ERROR, "missing-fetch",
                          "fetch target %r exists but no op produces it "
                          "(its producer was pruned?)" % n, var_names=[n])

    # -- sub-block attrs -----------------------------------------------
    def _check_sub_block_attrs(self, program, diags):
        nblocks = len(program.blocks)
        for bidx, oidx, op in opgraph.iter_all_ops(program):
            for key, val in op.attrs.items():
                if not key.startswith("sub_block"):
                    continue
                if not isinstance(val, int) or not (0 < val < nblocks):
                    diags.add(ERROR, "bad-sub-block",
                              "op %r attr %r references block %r which "
                              "does not exist" % (op.type, key, val),
                              block_idx=bidx, op_idx=oidx, op_type=op.type,
                              provenance=_provenance(op))
                    continue
                sub = program.blocks[val]
                if sub.parent_idx != bidx:
                    diags.add(ERROR, "bad-sub-block",
                              "op %r attr %r references block %d whose "
                              "parent is block %d, not the anchoring "
                              "block %d"
                              % (op.type, key, val, sub.parent_idx, bidx),
                              block_idx=bidx, op_idx=oidx, op_type=op.type,
                              provenance=_provenance(op))

    # -- whole-program shape re-inference ------------------------------
    def _check_shapes(self, program, diags):
        from ..fluid.core.registry import has_op
        from ..fluid.framework import _DYN_SENTINEL
        from ..fluid.core import dtypes as dtypes_mod

        for block in program.blocks:
            for oidx, op in enumerate(block.ops):
                if not has_op(op.type):
                    continue  # unknown-op already reported
                if any(block._find_var_recursive(n) is None
                       for n in op.all_input_names()):
                    continue  # dangling-input already reported
                try:
                    out_structs = block._eval_op_structs(op)
                except Exception as e:
                    diags.add(ERROR, "shape-inference-failed",
                              "re-inference of op %r failed: %s"
                              % (op.type, e),
                              block_idx=block.idx, op_idx=oidx,
                              op_type=op.type, provenance=_provenance(op))
                    continue
                for slot, names in op.outputs.items():
                    if slot not in out_structs:
                        diags.add(ERROR, "missing-out-slot",
                                  "op %r lowering produced no slot %r"
                                  % (op.type, slot),
                                  block_idx=block.idx, op_idx=oidx,
                                  op_type=op.type,
                                  provenance=_provenance(op))
                        continue
                    structs = out_structs[slot]
                    if len(names) != len(structs):
                        diags.add(ERROR, "out-arity-mismatch",
                                  "op %r slot %r lists %d output name(s) "
                                  "but the lowering produces %d value(s)"
                                  % (op.type, slot, len(names),
                                     len(structs)),
                                  block_idx=block.idx, op_idx=oidx,
                                  op_type=op.type, var_names=list(names),
                                  provenance=_provenance(op))
                        continue
                    for name, st in zip(names, structs):
                        v = block._find_var_recursive(name)
                        if v is None or v.shape is None:
                            continue  # dangling-output already reported
                        inferred = tuple(
                            -1 if s == _DYN_SENTINEL else int(s)
                            for s in st.shape)
                        if tuple(v.shape) != inferred:
                            diags.add(
                                ERROR, "shape-mismatch",
                                "var %r records shape %s but op %r infers "
                                "%s" % (name, tuple(v.shape), op.type,
                                        inferred),
                                block_idx=block.idx, op_idx=oidx,
                                op_type=op.type, var_names=[name],
                                provenance=_provenance(op))
                        want_dt = dtypes_mod.recorded(st.dtype)
                        if not v.persistable and v.dtype != want_dt:
                            # persistable outs keep their declared dtype at
                            # build time too (_infer_op skips them)
                            diags.add(
                                ERROR, "dtype-mismatch",
                                "var %r records dtype %s but op %r infers "
                                "%s" % (name, v.dtype, op.type, want_dt),
                                block_idx=block.idx, op_idx=oidx,
                                op_type=op.type, var_names=[name],
                                provenance=_provenance(op))

    # -- orphans (post-pass safety net) --------------------------------
    def _check_orphans(self, program, diags):
        diags.extend(find_orphan_vars(program))


def find_orphan_vars(program):
    """Vars in some block's var table that nothing references: no op
    input/output (real or serialized sub-op), no name-list attr.  A pass
    that rewires op outputs without cleaning the table leaves these behind
    with stale shape metadata (the BatchNormActFusePass regression)."""
    from ..fluid.framework import Parameter

    diags = Diagnostics()
    referenced = opgraph.referenced_names(program)
    for block in program.blocks:
        for name, v in block.vars.items():
            if name in referenced:
                continue
            if v.persistable or v.is_data or isinstance(v, Parameter):
                continue
            if getattr(v, "selected_rows", None):
                continue
            diags.add(WARNING, "orphan-var",
                      "var %r in block %d is referenced by no op — stale "
                      "entry left by a pass or manual edit?"
                      % (name, block.idx),
                      block_idx=block.idx, var_names=[name])
    return diags


# ---------------------------------------------------------------------------
# module-level conveniences (the public API most callers use)
# ---------------------------------------------------------------------------

def verify_program(program, feed_names=None, fetch_names=None,
                   check_shapes=True, check_orphans=False):
    """Run the ProgramVerifier; returns a Diagnostics collection."""
    return ProgramVerifier(
        check_shapes=check_shapes, check_orphans=check_orphans,
    ).verify(program, feed_names=feed_names, fetch_names=fetch_names)


def assert_program_valid(program, feed_names=None, fetch_names=None,
                         check_shapes=True, check_orphans=False,
                         what="program"):
    """verify_program + raise ProgramVerificationError on any error."""
    diags = verify_program(program, feed_names=feed_names,
                           fetch_names=fetch_names,
                           check_shapes=check_shapes,
                           check_orphans=check_orphans)
    failures = diags.errors() + (
        diags.by_code("orphan-var") if check_orphans else [])
    if failures:
        raise ProgramVerificationError(
            "%s failed static verification (%d finding(s))"
            % (what, len(failures)), diagnostics=diags)
    return diags
