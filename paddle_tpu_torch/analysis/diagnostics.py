"""Structured diagnostics for the verifier and lint engine.

Capability parity: reference static checks surface as scattered
`PADDLE_ENFORCE` aborts with C++ stack traces; here every finding is a
:class:`Diagnostic` carrying severity, the offending block/op coordinates,
the var names involved, and (when `FLAGS_op_callstack` provenance capture
is on) the Python callsite that appended the op — so tooling can render,
filter, and test on exact findings instead of grepping error strings.
"""

from __future__ import annotations

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


class Diagnostic:
    """One finding: `code` identifies the invariant/rule, `message` is the
    human-readable statement, coordinates locate the op."""

    def __init__(self, severity, code, message, block_idx=None, op_idx=None,
                 op_type=None, var_names=(), provenance=None, pass_name=None,
                 fix=None):
        self.severity = severity
        self.code = code
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.provenance = list(provenance or [])
        self.pass_name = pass_name
        # the registered fluid.ir pass (by name) that mechanically fixes
        # this finding, when one exists — the rule<->pass linkage the
        # autotuner and `apply_passes` act on (e.g. the perf lints name
        # "matmul_bias_act_fuse" / "transpose_fold")
        self.fix = fix

    def to_dict(self):
        return {
            "severity": self.severity,
            "code": self.code,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_idx": self.op_idx,
            "op_type": self.op_type,
            "var_names": list(self.var_names),
            "provenance": list(self.provenance),
            "pass_name": self.pass_name,
            "fix": self.fix,
        }

    def format(self):
        where = []
        if self.block_idx is not None:
            where.append("block %d" % self.block_idx)
        if self.op_idx is not None:
            where.append("op %d" % self.op_idx)
        if self.op_type:
            where.append(self.op_type)
        loc = " @ " + "/".join(where) if where else ""
        prov = ""
        if self.provenance:
            prov = "\n    built at: " + " <- ".join(self.provenance)
        fix = ""
        if self.fix:
            fix = "\n    fix: apply_passes(program, [%r])" % self.fix
        return "[%s] %s: %s%s%s%s" % (
            self.severity.upper(), self.code, self.message, loc, prov, fix)

    def __repr__(self):
        return "Diagnostic(%s)" % self.format()


class Diagnostics:
    """Ordered collection of findings with severity helpers."""

    def __init__(self, items=None):
        self.items = list(items or [])

    def add(self, severity, code, message, **kw):
        d = Diagnostic(severity, code, message, **kw)
        self.items.append(d)
        return d

    def extend(self, other):
        self.items.extend(
            other.items if isinstance(other, Diagnostics) else other)
        return self

    def errors(self):
        return [d for d in self.items if d.severity == ERROR]

    def warnings(self):
        return [d for d in self.items if d.severity == WARNING]

    def by_code(self, code):
        return [d for d in self.items if d.code == code]

    @property
    def has_errors(self):
        return any(d.severity == ERROR for d in self.items)

    def sorted(self):
        return sorted(
            self.items, key=lambda d: (_SEVERITY_ORDER.get(d.severity, 3),
                                       d.block_idx or 0, d.op_idx or 0))

    def format(self, max_items=None):
        items = self.sorted()
        if max_items is not None:
            items = items[:max_items]
        if not items:
            return "no findings"
        lines = [d.format() for d in items]
        ne, nw = len(self.errors()), len(self.warnings())
        lines.append("-- %d error(s), %d warning(s), %d finding(s) total"
                     % (ne, nw, len(self.items)))
        return "\n".join(lines)

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __bool__(self):
        return bool(self.items)


class ProgramVerificationError(RuntimeError):
    """Raised when a hot-path verification (apply_passes(verify=True),
    FLAGS_verify_program, save/load paths) finds error-severity
    diagnostics.  Carries the full Diagnostics for programmatic access."""

    def __init__(self, message, diagnostics=None, pass_name=None):
        self.diagnostics = diagnostics or Diagnostics()
        self.pass_name = pass_name
        detail = self.diagnostics.format(max_items=20)
        super().__init__("%s\n%s" % (message, detail))
