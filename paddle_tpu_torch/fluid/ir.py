"""IR pass framework: Pass / registry / pattern rewriting over Programs.

Counterpart of `paddle_tpu/fluid/ir.py`, with every pass it has:
`DeadOpEliminationPass`, `BatchNormActFusePass`,
`MatmulBiasActFusePass` and `TransposeFoldPass`.  Passes rewrite the
JSON IR only (`framework.Program`), so they run on any program the port
can load, whether or not it has the ops they produce.  After
``matmul_bias_act_fuse`` each fused FFN, pooler and fc + relu runs as
one launch of the fused-epilogue GEMM kernel (`ops.matmul_bias_act`).
"""

from __future__ import annotations


_PASS_REGISTRY: dict = {}


class Pass:
    """cf. ir/pass.h: named transform over a Program; `set(...)` carries
    attributes (reference Pass::Set)."""

    name = None

    def __init__(self):
        self._attrs = {}

    def set(self, key, value):
        self._attrs[key] = value
        return self

    def get(self, key, default=None):
        return self._attrs.get(key, default)

    def apply(self, program):
        """Transform `program` IN PLACE and return it."""
        raise NotImplementedError


def register_pass(cls):
    """Decorator: register a Pass subclass by its `name`."""
    if not getattr(cls, "name", None):
        raise ValueError("a Pass must define a class-level `name`")
    _PASS_REGISTRY[cls.name] = cls
    return cls


def get_pass(name):
    """cf. PassRegistry::Instance().Get."""
    if name not in _PASS_REGISTRY:
        raise KeyError(
            "no pass named %r (registered: %s)"
            % (name, ", ".join(sorted(_PASS_REGISTRY))))
    return _PASS_REGISTRY[name]()


def apply_passes(program, names, verify=False):
    """Run a pass pipeline (cf. PassBuilder) over the program.

    verify=True re-runs the whole-program static verifier (structural
    invariants + shape re-inference + orphan-var check, see
    `paddle_tpu_torch.analysis`) AFTER EACH pass and raises a
    ProgramVerificationError NAMING the offending pass — so a broken
    rewrite fails at the pass boundary, not deep inside Executor.run."""
    if verify:
        from ..analysis import assert_program_valid

        assert_program_valid(
            program, check_orphans=True,
            what="program handed to apply_passes (before any pass ran)")
    for n in names:
        p = n if isinstance(n, Pass) else get_pass(n)
        program = p.apply(program)
        if verify:
            from ..analysis import (
                ProgramVerificationError, assert_program_valid,
            )

            pass_name = getattr(p, "name", None) or type(p).__name__
            try:
                assert_program_valid(
                    program, check_orphans=True,
                    what="program after pass %r" % pass_name)
            except ProgramVerificationError as e:
                e.pass_name = pass_name
                raise
    return program


def clone_and_apply(program, names, verify=True):
    """Run a pass pipeline on a CLONE of `program` and return the clone:
    the original program is never mutated, so any number of pipeline
    variants can be compared side by side."""
    return apply_passes(program.clone(), list(names), verify=verify)


# ---------------------------------------------------------------------------
# pattern detection (cf. ir/graph_pattern_detector.h, reduced to the
# op-chain patterns the JSON IR needs)
# ---------------------------------------------------------------------------


def consumers_of(block, var_name):
    """Ops reading var_name, with their indices."""
    out = []
    for i, op in enumerate(block.ops):
        if var_name in op.all_input_names():
            out.append((i, op))
    return out


def match_chain(block, types):
    """Find (i0, [op...]) chains where op_k's FIRST output feeds op_{k+1}
    as its only consumer — the linear patterns fusion passes match
    (cf. GraphPatternDetector chains)."""
    matches = []
    ops = block.ops
    for i, op in enumerate(ops):
        if op.type != types[0]:
            continue
        chain = [op]
        ok = True
        cur = op
        for want in types[1:]:
            outs = cur.all_output_names()
            if not outs:
                ok = False
                break
            link = outs[0]
            cons = consumers_of(block, link)
            if len(cons) != 1 or cons[0][1].type != want:
                ok = False
                break
            cur = cons[0][1]
            chain.append(cur)
        if ok:
            matches.append((i, chain))
    return matches


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


@register_pass
class DeadOpEliminationPass(Pass):
    """Remove ops whose outputs are never consumed, fetched, or
    persistable (cf. the reference's eager-deletion/memory passes — at
    the program level the equivalent hygiene is deleting dead ops so the
    executor never lowers them).  Set("keep", [names]) protects extra
    vars (e.g. a fetch list known ahead of time).

    Liveness spans EVERY block plus the sub-block ops control flow and
    recompute serialize into attrs: a var consumed only inside a
    cond/while/static_rnn body (or referenced through a name-list attr
    like ``cap_names``) keeps its parent-block producer alive, and an op
    whose sub-block contains a side effect (e.g. a cond that prints) is
    never deleted.  Vars stranded by op removal are dropped from their
    block's var table so the pass leaves no orphans behind."""

    name = "dead_op_elimination"

    def apply(self, program):
        from ..analysis import opgraph

        keep = set(self.get("keep", []))
        changed = True
        while changed:
            changed = False
            live = set(keep)
            # reads from every real op in every block, every serialized
            # sub-op, and every name-list attr (sub-block alias bindings)
            for _b, _i, op in opgraph.iter_all_ops_deep(program):
                live.update(opgraph.input_names(op))
                for _k, vals in opgraph.attr_name_lists(op):
                    live.update(vals)
            for block in program.blocks:
                for v in block.vars.values():
                    if getattr(v, "persistable", False):
                        live.add(v.name)
            for block in program.blocks:
                kept_ops = []
                for op in block.ops:
                    outs = op.all_output_names()
                    if (opgraph.has_side_effects(op) or not outs
                            or any(o in live for o in outs)
                            or op.attrs.get("op_role") == "optimize"):
                        kept_ops.append(op)
                    else:
                        changed = True
                block.ops[:] = kept_ops
        # drop vars the removed ops stranded (orphan hygiene: the verifier
        # flags unreferenced entries, and a later pass must not trip over
        # stale shape metadata)
        opgraph.drop_orphan_vars(program, keep=keep)
        program._bump()
        return program


@register_pass
class BatchNormActFusePass(Pass):
    """batch_norm + act (sole consumer) -> fused_batch_norm_act — a real
    PatternDetector-style rewrite targeting an op of the reference's
    library (cf. reference fused_bn_activation and conv_bn_fuse_pass.cc
    machinery).  The fused op runs ``batch_norm``'s lowering and then
    the activation's (`fluid/ops/tail_nn_ops.py`)."""

    name = "batch_norm_act_fuse"

    _ACTS = ("relu", "sigmoid", "tanh")

    def apply(self, program):
        from ..analysis import opgraph

        block = program.current_block()
        rewired = []
        for act in self._ACTS:
            while True:
                matches = match_chain(block, ["batch_norm", act])
                if not matches:
                    break
                _, (bn, act_op) = matches[0]
                bn.type = "fused_batch_norm_act"
                bn.attrs["act_type"] = act
                # the fused op's Y takes the activation's output name
                act_out = act_op.all_output_names()[0]
                old_y = bn.outputs["Y"][0]
                bn.outputs["Y"] = [act_out]
                block.ops.remove(act_op)
                if old_y != act_out:
                    rewired.append(old_y)
        # the rewiring strands the original batch_norm Y name: drop it
        # from the var table (it held stale shape metadata and tripped
        # the orphan-var verifier rule) unless something else still
        # references it
        if rewired:
            opgraph.drop_orphan_vars(program, candidates=rewired)
        program._bump()
        return program


def _deep_read_counts(program):
    """{name: times read} over every real op in every block, every
    serialized sub-op, and every name-list attr.  A fusion may only
    consume an intermediate whose EVERY read it rewrites — a block-local
    consumer count would miss a cond body or a recompute segment reading
    the var.  Built ONCE per rewrite scan (one program walk) instead of
    per lookup, so a pass sweep stays linear in program size."""
    from ..analysis import opgraph

    counts = {}
    for _b, _i, op in opgraph.iter_all_ops_deep(program):
        for n in opgraph.input_names(op):
            counts[n] = counts.get(n, 0) + 1
        for _k, vals in opgraph.attr_name_lists(op):
            for n in vals:
                counts[n] = counts.get(n, 0) + 1
    return counts


@register_pass
class MatmulBiasActFusePass(Pass):
    """matmul/mul -> elementwise_add(1-D bias on the last dim) -> act
    (sole consumers throughout) -> ONE ``matmul_bias_act`` op — the
    rewrite for exactly the chains the ``unfused-epilogue`` perf-lint
    rule flags (its diagnostics carry ``fix="matmul_bias_act_fuse"``).
    On a CUDA tensor the fused op launches the fused-epilogue GEMM
    kernel (bias + activation applied on the f32 accumulator tile
    before the write-back); elsewhere it runs that kernel's plain
    version.

    Also fuses the reshape-interposed variant the BERT FFN can emit
    (matmul -> reshape2* -> add -> act): the epilogue commutes with a
    reshape that preserves the bias (last) dim, so the activation moves
    into the matmul and the reshapes slide after it.  Chains whose
    bias is not a last-dim 1-D vector, whose intermediates have other
    consumers (anywhere, sub-blocks included), or whose activation the
    kernel lacks are left alone."""

    name = "matmul_bias_act_fuse"

    _ACTS = ("relu", "tanh", "gelu")

    def apply(self, program):
        from ..analysis import opgraph

        block = program.current_block()
        stranded = []
        changed = True
        while changed:
            changed = False
            # fresh read-count index per scan: each rewrite invalidates
            # it, and each scan performs at most one rewrite
            reads = _deep_read_counts(program)
            for op in block.ops:
                if op.type not in ("matmul", "mul"):
                    continue
                m = self._match(block, op, reads)
                if m is None:
                    continue
                self._rewrite(block, op, m, stranded)
                changed = True
                break
        if stranded:
            opgraph.drop_orphan_vars(program, candidates=stranded)
        program._bump()
        return program

    def _sole_consumer(self, block, name, reads):
        """The single op reading `name`, or None when the read count
        anywhere in the program is not exactly one."""
        if reads.get(name, 0) != 1:
            return None
        cons = consumers_of(block, name)
        return cons[0][1] if len(cons) == 1 else None

    def _var(self, block, name):
        return block._find_var_recursive(name)

    def _match(self, block, mm, reads):
        outs = mm.all_output_names()
        if not outs:
            return None
        out_v = self._var(block, outs[0])
        if out_v is None or not out_v.shape:
            return None
        last_dim = out_v.shape[-1]
        # walk through sole-consumer reshapes that keep the bias dim
        mids = []
        cur = outs[0]
        nxt = self._sole_consumer(block, cur, reads)
        # both registered reshape spellings — the lint's fixable guard
        # accepts the same set, so every fix-hinted chain really fuses
        while nxt is not None and nxt.type in ("reshape2", "reshape"):
            r_out = nxt.all_output_names()
            r_v = self._var(block, r_out[0]) if r_out else None
            if r_v is None or not r_v.shape or r_v.shape[-1] != last_dim:
                return None
            mids.append(nxt)
            cur = r_out[0]
            nxt = self._sole_consumer(block, cur, reads)
        add = nxt
        if add is None or add.type != "elementwise_add":
            return None
        # the chain value must be X (bias broadcasts ONTO it); bias is Y
        if add.inputs.get("X", [None])[0] != cur:
            return None
        bias_name = add.inputs.get("Y", [None])[0]
        bias_v = self._var(block, bias_name) if bias_name else None
        if (bias_v is None or bias_v.shape is None
                or len(bias_v.shape) != 1
                or int(bias_v.shape[0]) != int(last_dim)):
            return None
        chain_v = self._var(block, cur)
        axis = add.attrs.get("axis", -1)
        ndim = (len(chain_v.shape)
                if chain_v is not None and chain_v.shape else None)
        if ndim is None or axis not in (-1, ndim - 1):
            return None
        a_out = add.all_output_names()
        if not a_out:
            return None
        act = self._sole_consumer(block, a_out[0], reads)
        if act is None or act.type not in self._ACTS:
            return None
        act_out = act.all_output_names()
        if not act_out:
            return None
        return mids, add, act, bias_name

    def _rewrite(self, block, mm, match, stranded):
        mids, add, act, bias_name = match
        mm.type = "matmul_bias_act"
        mm.attrs["act_type"] = act.type
        if act.type == "gelu":
            mm.attrs["approximate"] = act.attrs.get("approximate", False)
        mm.inputs["Bias"] = [bias_name]
        act_out = act.all_output_names()[0]
        if mids:
            # epilogue moves into the matmul; the reshapes slide after
            # it, and the LAST reshape takes over the activation's
            # output name (its recorded shape already matches)
            last = mids[-1]
            stranded.append(last.outputs["Out"][0])
            last.outputs["Out"] = [act_out]
        else:
            stranded.append(mm.outputs["Out"][0])
            mm.outputs["Out"] = [act_out]
        stranded.append(add.all_output_names()[0])
        block.ops.remove(add)
        block.ops.remove(act)


@register_pass
class TransposeFoldPass(Pass):
    """Cancel inverse-permutation transpose pairs so relayout passes
    never hit device memory — the fix for the ``layout-transpose-hazard`` lint
    (its diagnostics carry ``fix="transpose_fold"``).  Three rewrites,
    most specific first:

    1. **flash-attention layout fold** — transpose([0,2,1,3]) on Q/K/V
       into a BHSD ``flash_attention`` whose output is transposed
       straight back: the kernel already reads BSHD natively
       (``layout`` attr), so the pass flips the attr and deletes all
       four transposes — the model never materializes
       [B,S,H,D]<->[B,H,S,D].
    2. **adjacent pair** — transpose(p1) -> transpose(p2) with
       p1∘p2 = identity (p1's out consumed only by p2): the second
       transpose becomes an ``assign`` and the first
       is deleted when nothing else reads it.  The assign keeps every
       downstream name — including fetch targets — produced.
    3. **matmul flag absorption** — a last-two-dims transpose consumed
       only by one matmul folds into its ``transpose_X``/``transpose_Y``
       attr (the GEMM takes either operand order).

    Every rewrite is shape-neutral on recorded metadata, so
    ``apply_passes(verify=True)``'s re-inference stays green."""

    name = "transpose_fold"

    _T = ("transpose2", "transpose")

    def apply(self, program):
        from ..analysis import opgraph

        block = program.current_block()
        stranded = []
        changed = True
        while changed:
            # fresh read-count index per scan (each scan does at most
            # one rewrite, which invalidates it)
            reads = _deep_read_counts(program)
            changed = (self._fold_flash_layout(block, stranded, reads)
                       or self._fold_adjacent(block, stranded, reads)
                       or self._fold_into_matmul(block, stranded, reads))
        if stranded:
            opgraph.drop_orphan_vars(program, candidates=stranded)
        program._bump()
        return program

    @staticmethod
    def _perm(op):
        p = op.attrs.get("axis")
        return list(p) if isinstance(p, (list, tuple)) else None

    @staticmethod
    def _identity_compose(p1, p2):
        if p1 is None or p2 is None or len(p1) != len(p2):
            return False
        n = len(p1)
        return all(0 <= p2[j] < n and p1[p2[j]] == j for j in range(n))

    def _producer(self, block, name, before_idx):
        from ..analysis import opgraph

        return opgraph.producer_before(block, name, before_idx)

    def _delete_if_unread(self, block, op, stranded, reads):
        out = op.all_output_names()
        if out and reads.get(out[0], 0) == 0:
            v = block._find_var_recursive(out[0])
            if v is None or not getattr(v, "persistable", False):
                block.ops.remove(op)
                stranded.append(out[0])
                return True
        return False

    # -- rewrite 1: flash_attention BSHD layout fold -------------------
    _HEAD_SWAP = [0, 2, 1, 3]

    def _fold_flash_layout(self, block, stranded, reads):
        for fidx, f in enumerate(block.ops):
            if (f.type != "flash_attention"
                    or f.attrs.get("layout", "BHSD") != "BHSD"):
                continue
            slot_names = {s: f.inputs.get(s, [None])[0]
                          for s in ("Q", "K", "V")}
            ins = {}
            ok = True
            for slot, name in slot_names.items():
                found = (self._producer(block, name, fidx)
                         if name else None)
                # a shared transpose (e.g. K and V from one transposed
                # tensor) is foldable as long as EVERY read of its
                # output is one of THIS op's Q/K/V slots
                n_here = sum(1 for n in slot_names.values()
                             if n == name)
                if (found is None or found[1].type not in self._T
                        or self._perm(found[1]) != self._HEAD_SWAP
                        or reads.get(name, 0) != n_here):
                    ok = False
                    break
                ins[slot] = found[1]
            if not ok:
                continue
            out_name = f.all_output_names()[0]
            if reads.get(out_name, 0) != 1:
                continue
            t_out = next((op for _i, op in consumers_of(block, out_name)),
                         None)
            if (t_out is None or t_out.type not in self._T
                    or self._perm(t_out) != self._HEAD_SWAP):
                continue
            # dedup: a shared transpose appears under several slots but
            # must be deleted (and its out var stranded) only once
            tposes = {id(ins[s]): ins[s] for s in ins}
            for slot, t in ins.items():
                f.inputs[slot] = [t.inputs["X"][0]]
            f.attrs["layout"] = "BSHD"
            stranded.append(out_name)
            f.outputs["Out"] = [t_out.all_output_names()[0]]
            for t in tposes.values():
                stranded.append(t.all_output_names()[0])
                block.ops.remove(t)
            block.ops.remove(t_out)
            return True
        return False

    # -- rewrite 2: adjacent inverse pair ------------------------------
    def _fold_adjacent(self, block, stranded, reads):
        for idx, t2 in enumerate(block.ops):
            if t2.type not in self._T:
                continue
            p2 = self._perm(t2)
            name = t2.inputs.get("X", [None])[0]
            found = self._producer(block, name, idx) if name else None
            if found is None:
                continue
            t1 = found[1]
            if (t1.type not in self._T
                    or not self._identity_compose(self._perm(t1), p2)
                    or reads.get(name, 0) != 1):
                continue
            # t2 becomes a no-op copy of t1's input (keeps every
            # downstream name — fetch targets included — produced)
            t2.type = "assign"
            t2.inputs = {"X": [t1.inputs["X"][0]]}
            t2.attrs.pop("axis", None)
            reads[name] = 0    # t2 no longer reads t1's output
            self._delete_if_unread(block, t1, stranded, reads)
            return True
        return False

    # -- rewrite 3: fold a last-two-dims swap into matmul's flags ------
    @staticmethod
    def _is_last_two_swap(p):
        if p is None or len(p) < 2:
            return False
        n = len(p)
        return (p[:-2] == list(range(n - 2))
                and p[-2] == n - 1 and p[-1] == n - 2)

    def _fold_into_matmul(self, block, stranded, reads):
        for idx, t in enumerate(block.ops):
            if t.type not in self._T:
                continue
            if not self._is_last_two_swap(self._perm(t)):
                continue
            out = t.all_output_names()
            if not out or reads.get(out[0], 0) != 1:
                continue
            mm = next((op for _i, op in consumers_of(block, out[0])),
                      None)
            if mm is None or mm.type != "matmul":
                continue
            if mm.inputs.get("X", [None])[0] == out[0]:
                slot, flag = "X", "transpose_X"
            elif mm.inputs.get("Y", [None])[0] == out[0]:
                slot, flag = "Y", "transpose_Y"
            else:
                continue
            cur = mm.attrs.get(flag, mm.attrs.get(flag.lower(), False))
            mm.attrs[flag] = not cur
            mm.attrs.pop(flag.lower(), None)
            mm.inputs[slot] = [t.inputs["X"][0]]
            stranded.append(out[0])
            block.ops.remove(t)
            return True
        return False
