"""Program / Block / Operator / Variable — the serializable graph IR.

Counterpart of `paddle_tpu/fluid/framework.py`, with the same JSON IR
(`Program.to_dict` / `from_dict` / `to_json` / `from_json`), so a
``__model__.json`` written by either package loads in the other.

What changes is how an op's output shapes are found at build time: the
reference runs `jax.eval_shape` over the op's lowering; the port runs
the op's PyTorch lowering on ``device="meta"`` tensors, which carry a
shape and a dtype and no data.  Dynamic (batch) dims are declared as -1
and stand in as a sentinel extent during inference, as in the reference.
"""

from __future__ import annotations

import contextlib
import copy
import json

import torch

from . import unique_name
from .core import dtypes as dtypes_mod
from .core.registry import LowerContext, get_op_def

GRAD_SUFFIX = "@GRAD"

# Sentinel extent substituted for -1 dims during graph-time shape inference;
# a large prime so it never collides with a real layer dimension, letting us
# map it back to -1 in inferred output shapes.
_DYN_SENTINEL = 1031

# update ops that `Program.clone(for_test=True)` prunes even without an
# ``op_role`` attr (the reference's `fluid/ops/optimizer_ops.py` set)
OPTIMIZER_OP_TYPES = frozenset({
    "sgd", "momentum", "adam", "adamw", "lamb", "adagrad", "adadelta",
    "rmsprop", "adamax", "decayed_adagrad", "ftrl", "lars_momentum", "dpsgd",
})


def _format_op_input_structs(block, op):
    """'slot=[name(shape, dtype), ...]' summary for inference errors."""
    parts = []
    for slot, names in op.inputs.items():
        descs = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None:
                descs.append("%s(<undefined>)" % n)
            else:
                descs.append("%s(%s, %s)" % (n, v.shape, v.dtype))
        parts.append("%s=[%s]" % (slot, ", ".join(descs)))
    return "; ".join(parts) if parts else "<no inputs>"


class Variable:
    """A named tensor in a Block (cf. reference framework.py:835 / VarDesc)."""

    def __init__(
        self,
        block,
        name,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = dtypes_mod.to_str(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    def __bool__(self):
        # a static Variable has no value at build time; silently defaulting
        # to True would bake one branch of `if tensor:` into the program
        raise RuntimeError(
            "Cannot use a static-graph Variable '%s' as a Python bool."
            % self.name)

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def astype(self, dtype):
        from .layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def _meta(self):
        """A meta tensor of this var's shape (dynamic dims substituted)
        and dtype, for shape inference."""
        shape = tuple(_DYN_SENTINEL if s == -1 else s for s in (self.shape or ()))
        return torch.empty(shape, dtype=dtypes_mod.to_torch(self.dtype),
                           device="meta")

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "kind": "param" if isinstance(self, Parameter) else "var",
        }
        if isinstance(self, Parameter):
            d["trainable"] = self.trainable
            d["optimize_attr"] = self.optimize_attr
            d["need_clip"] = self.need_clip
        return d

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name,
            self.shape,
            self.dtype,
            ", persistable" if self.persistable else "",
        )

    # Python operator sugar (cf. reference math_op_patch.py) -----------------
    def _binary(self, other, fn, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, fn, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)

    def __neg__(self):
        from .layers import ops as _ops

        return _ops.scale(self, scale=-1.0)


class Parameter(Variable):
    """Persistable trainable variable (cf. reference framework.py:4962)."""

    def __init__(self, block, name, shape, dtype="float32", **kw):
        self.trainable = kw.pop("trainable", True)
        self.optimize_attr = kw.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kw.pop("regularizer", None)
        self.need_clip = kw.pop("need_clip", True)
        self.is_distributed = kw.pop("is_distributed", False)
        super().__init__(
            block,
            name,
            shape=shape,
            dtype=dtype,
            persistable=True,
            stop_gradient=not self.trainable,
        )


class OpInputResolutionError(RuntimeError):
    """An op input name resolves to no Variable (raised during shape
    inference so callers can tell it apart from lowering failures)."""


class Operator:
    """One op invocation (cf. reference framework.py:1822 / OpDesc).

    inputs / outputs: {slot_name: [var_name, ...]} keyed by the OpDef's
    declared slots.  attrs: JSON-serializable static attributes.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def all_input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def all_output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": self.attrs,
        }

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (
            self.type,
            ", ".join("%s=%s" % kv for kv in self.inputs.items()),
            ", ".join("%s=%s" % kv for kv in self.outputs.items()),
        )


class Block:
    """Ordered ops + var table (cf. reference framework.py:2391 / BlockDesc)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = {}
        self.ops: list[Operator] = []

    # -- vars ---------------------------------------------------------------
    def create_var(self, name=None, **kw):
        name = name or unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw):
        p = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError("variable '%s' not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = self.program.blocks[b.parent_idx] if b.parent_idx >= 0 else None
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None, infer=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        if infer:
            self._infer_op(op)
        self.program._bump()
        return op

    def _eval_op_structs(self, op):
        """The op's lowering run on meta tensors: {out_slot: [meta
        tensor, ...]}.

        Shared by build-time `_infer_op` and the analysis verifier's
        whole-program shape re-inference (paddle_tpu_torch.analysis
        .verifier) — one inference implementation, replayable over
        mutated programs."""
        opdef = get_op_def(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            metas = []
            for n in names:
                v = self._find_var_recursive(n)
                if v is None:
                    raise OpInputResolutionError(
                        "op '%s' reads var '%s' (slot %s) which is not "
                        "defined in block %d or its ancestors"
                        % (op.type, n, slot, self.idx))
                metas.append(v._meta())
            ins[slot] = metas
        ctx = LowerContext(is_test=True, device="meta")
        with torch.no_grad():
            return opdef.lower(ctx, ins, op.attrs)

    def _infer_op(self, op):
        """Graph-time shape/dtype inference: the lowering on meta tensors."""
        try:
            out_structs = self._eval_op_structs(op)
        except OpInputResolutionError:
            raise
        except Exception as e:
            raise RuntimeError(
                "shape inference failed for op %r: %s\n  with inputs: %s"
                % (op, e, _format_op_input_structs(self, op))
            ) from e

        for slot, names in op.outputs.items():
            if slot not in out_structs:
                raise RuntimeError(
                    "op '%s' lowering produced no slot '%s'" % (op.type, slot)
                )
            structs = out_structs[slot]
            for name, st in zip(names, structs):
                shape = tuple(-1 if s == _DYN_SENTINEL else int(s)
                              for s in st.shape)
                v = self._find_var_recursive(name)
                if v is None:
                    v = Variable(self, name)
                    self.vars[name] = v
                if v.shape is None or not v.persistable:
                    v.shape = shape
                    v.dtype = dtypes_mod.recorded(st.dtype)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }


class Program:
    """A serializable multi-block program (cf. reference framework.py:3852)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self.random_seed = None
        self._is_test = False

    # -- structure ----------------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _bump(self):
        self._version += 1

    def all_parameters(self):
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- transforms ---------------------------------------------------------
    def clone(self, for_test=False):
        """Deep copy; for_test=True flips is_test attrs and prunes optimizer
        ops (cf. reference Program.clone(for_test=True))."""
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = self.current_block_idx
        p._version = 0
        p.random_seed = self.random_seed
        p._is_test = for_test or self._is_test
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for v in b.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[v.name] = nv
            for o in b.ops:
                if for_test and (
                    o.attrs.get("op_role") in ("backward", "optimize")
                    or o.type in OPTIMIZER_OP_TYPES
                ):
                    continue
                no = Operator(nb, o.type, o.inputs, o.outputs,
                              copy.deepcopy(o.attrs))
                if for_test and "is_test" in no.attrs:
                    no.attrs["is_test"] = True
                nb.ops.append(no)
            p.blocks.append(nb)
        if for_test:
            # pruning backward/optimizer ops strands their grad vars; drop
            # entries no kept op references
            from ..analysis import opgraph

            opgraph.drop_orphan_vars(p)
        p._bump()
        return p

    # -- serialization ------------------------------------------------------
    def to_dict(self):
        return {
            "version": 1,
            "blocks": [b.to_dict() for b in self.blocks],
            "random_seed": self.random_seed,
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p._version = 0
        p.random_seed = d.get("random_seed")
        p._is_test = False
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                kw = dict(
                    shape=vd["shape"],
                    dtype=vd["dtype"],
                )
                if vd.get("kind") == "param":
                    v = Parameter(
                        b,
                        vd["name"],
                        trainable=vd.get("trainable", True),
                        optimize_attr=vd.get("optimize_attr", {"learning_rate": 1.0}),
                        need_clip=vd.get("need_clip", True),
                        **kw,
                    )
                else:
                    v = Variable(
                        b,
                        vd["name"],
                        persistable=vd["persistable"],
                        stop_gradient=vd["stop_gradient"],
                        is_data=vd.get("is_data", False),
                        **kw,
                    )
                b.vars[vd["name"]] = v
            for od in bd["ops"]:
                b.ops.append(
                    Operator(b, od["type"], od["inputs"], od["outputs"], od["attrs"])
                )
            p.blocks.append(b)
        return p

    @staticmethod
    def from_json(s) -> "Program":
        return Program.from_dict(json.loads(s))

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            for v in b.vars.values():
                lines.append("  " + repr(v))
            for o in b.ops:
                lines.append("  " + repr(o))
        return "\n".join(lines)


def grad_var_name(name):
    """``<name>@GRAD``: the name `backward.append_backward` gives the
    total gradient of var ``name``."""
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Default-program machinery (cf. reference framework.py:5287 program_guard)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = old_main
        _startup_program = old_startup

