"""Scope: hierarchical name -> tensor store for persistable variables.

Counterpart of `paddle_tpu/fluid/core/scope.py`, with torch tensors as
values: parameters and other persistable state live here between runs
(the executor writes a startup program's outputs into it, `io` loads
saved values into it).
"""

from __future__ import annotations


class Scope:
    def __init__(self, parent: "Scope" = None):
        self._vars = {}
        self._parent = parent
        self._kids = []

    def new_scope(self) -> "Scope":
        s = Scope(self)
        self._kids.append(s)
        return s

    def var(self, name):
        """Find-or-declare a slot in THIS scope (cf. Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def set(self, name, value):
        self._vars[name] = value

    def find_var(self, name):
        """Lookup with parent fallback (cf. Scope::FindVar). None if absent."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def has(self, name):
        s = self
        while s is not None:
            if name in s._vars and s._vars[name] is not None:
                return True
            s = s._parent
        return False

    def erase(self, name):
        self._vars.pop(name, None)

    def local_names(self):
        return list(self._vars)

    def drop_kids(self):
        self._kids = []


_global_scope = Scope()


def global_scope() -> Scope:
    """cf. python/paddle/fluid/executor.py:41 global_scope()."""
    return _global_scope
