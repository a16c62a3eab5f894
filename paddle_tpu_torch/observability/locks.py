"""Runtime concurrency sanitizer: named locks, a lock-order graph, and
blocking-under-lock detection for the framework's own threading.

The reference framework leans on a ``SANITIZER_TYPE`` build axis (TSan /
ASan over the C++ core); this rebuild's serving tier is pure-Python
threads, so the equivalent is a *registry* of named lock wrappers:

* :func:`named_lock` / :func:`named_rlock` / :func:`named_condition`
  return drop-in ``threading`` primitives bound to a logical NAME.  In
  production they delegate straight to the raw primitive (one attribute
  check of overhead — pinned by tests/test_perf_gate.py).
* :func:`enable` arms the sanitizer: every acquisition records a bounded
  per-thread stack, feeds the global :class:`LockOrderGraph`, and is
  checked against the declared hierarchy.  An AB/BA inversion anywhere
  reports a potential deadlock — with BOTH acquisition stacks — before
  it ever hangs a drill.
* While enabled, the classic blocking seams (``time.sleep``,
  no-timeout ``queue.Queue.get`` / ``Event.wait``, ``subprocess``
  waits, socket/pipe I/O) are patched to flag execution under a
  registered lock, and ``signal.signal`` handlers are wrapped so taking
  a non-reentrant registered lock inside a handler is flagged
  (the flight-recorder deadlock shape).

The declared fleet hierarchy (see README "Concurrency analysis"):
ordered levels ``router -> registry -> replica -> engine`` (a holder may
only acquire locks at the same or a LATER level), plus leaf-only levels
``tracer`` / ``metrics`` (a leaf holder may not acquire any other
registered lock; acquiring a leaf while holding anything is fine).

This module is stdlib-only on purpose: observability is imported before
everything else, and lock wrappers must be importable from any layer
(fluid, serving, tp_serving) without cycles.  Findings are
:class:`Diagnostic` records (the port keeps its own copy of the fields
and ``format()`` it needs).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager


class Diagnostic:
    """One sanitizer finding: `code` names the rule, `message` states
    it, `provenance` holds the acquisition stacks."""

    def __init__(self, severity, code, message, var_names=(),
                 provenance=None, pass_name=None):
        self.severity = severity
        self.code = code
        self.message = message
        self.var_names = tuple(var_names)
        self.provenance = list(provenance or [])
        self.pass_name = pass_name

    def format(self):
        prov = ""
        if self.provenance:
            prov = "\n    built at: " + " <- ".join(self.provenance)
        return "[%s] %s: %s%s" % (
            self.severity.upper(), self.code, self.message, prov)

    def __repr__(self):
        return "Diagnostic(%s)" % self.format()

__all__ = [
    "LockOrderGraph",
    "LockRegistry",
    "SanitizedCondition",
    "SanitizedLock",
    "SanitizedRLock",
    "assert_clean",
    "clear_delays",
    "clear_findings",
    "declare_hierarchy",
    "disable",
    "enable",
    "findings",
    "install_delays",
    "named_condition",
    "named_lock",
    "named_rlock",
    "registry",
    "sanctioned",
    "sanitizing",
]

_STACK_DEPTH = 12
_SELF_TAIL = os.path.join("observability", "locks.py")
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# which registry (if any) currently owns the process-wide blocking
# patches — two registries patching time.sleep at once would restore in
# the wrong order, so the second enable(blocking=True) is an error
_PATCHED_BY = None


def _capture_stack(depth=_STACK_DEPTH):
    """Bounded raw-frame walk.  Unlike traceback.extract_stack this does
    no linecache I/O — cheap enough to run on every acquisition while
    the sanitizer is active.  Frames inside this module are skipped."""
    frames = []
    try:
        f = sys._getframe(1)
    except ValueError:                                    # pragma: no cover
        return frames
    while f is not None and len(frames) < depth:
        fn = f.f_code.co_filename
        if not fn.endswith(_SELF_TAIL):
            if fn.startswith(_REPO_ROOT):
                fn = fn[len(_REPO_ROOT) + 1:]
            frames.append("%s:%d in %s" % (fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return frames


def _indent(stack):
    return ["    " + s for s in stack] if stack else ["    <no stack>"]


class LockOrderGraph:
    """Directed graph of observed (or statically extracted) lock
    acquisition orders, keyed by logical lock NAME.  An edge A->B means
    "B was acquired while A was held"; a path B ->* A existing when the
    edge A->B lands is an AB/BA inversion.  The first observation of
    each edge keeps both acquisition stacks so inversions report the
    *historical* order too, not just the current one."""

    def __init__(self):
        self._adj = {}          # name -> {name: info dict}

    def add_edge(self, held, acquired, held_stack=(), acq_stack=(),
                 where=None):
        """Record held->acquired.  Returns the inversion path
        ``[acquired, ..., held]`` if the reverse order was already
        known, else None."""
        if held == acquired:
            return None
        cycle = self.find_path(acquired, held)
        edges = self._adj.setdefault(held, {})
        info = edges.get(acquired)
        if info is None:
            edges[acquired] = info = {
                "held_stack": list(held_stack),
                "acq_stack": list(acq_stack),
                "where": where,
                "count": 0,
            }
        info["count"] += 1
        return cycle

    def find_path(self, src, dst):
        """A path src ->* dst as a node list, or None."""
        if src == dst:
            return [src]
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            for nxt in self._adj.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def edge(self, a, b):
        return self._adj.get(a, {}).get(b)

    def edges(self):
        """Iterate (held, acquired, info) over every recorded edge."""
        for a, nbrs in sorted(self._adj.items()):
            for b, info in sorted(nbrs.items()):
                yield a, b, info

    def clear(self):
        self._adj.clear()


class _Held:
    __slots__ = ("lock", "count", "stack")


class SanitizedLock:
    """Drop-in ``threading.Lock`` bound to a logical name in a
    :class:`LockRegistry`.  Disabled-mode fast path is one attribute
    check before delegating to the raw primitive."""

    reentrant = False

    def __init__(self, reg, name):
        self._reg = reg
        self.name = name
        self._lk = self._make()

    def _make(self):
        return threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        reg = self._reg
        if reg._hot:
            return reg._acquire(self, blocking, timeout)
        return self._lk.acquire(blocking, timeout)

    def release(self):
        reg = self._reg
        if reg._hot or getattr(reg._tls, "held", None):
            return reg._release(self)
        return self._lk.release()

    def locked(self):
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return "<%s %r>" % (type(self).__name__, self.name)


class SanitizedRLock(SanitizedLock):
    """Drop-in ``threading.RLock`` (see :class:`SanitizedLock`)."""

    reentrant = True

    def _make(self):
        return threading.RLock()


class SanitizedCondition:
    """Drop-in ``threading.Condition`` over a registered lock.

    The raw ``threading.Condition`` is built over the *inner* primitive
    (not the wrapper) so its ``_is_owned`` probe stays correct; acquire
    and release route through the wrapper so the order graph sees them,
    and :meth:`wait` suspends the wrapper's held-entry while the raw
    condition releases the lock underneath."""

    def __init__(self, reg, name, lock=None):
        if lock is None:
            lock = SanitizedRLock(reg, name)
        elif not isinstance(lock, SanitizedLock):
            raise TypeError("named_condition(lock=...) needs a sanitized "
                            "lock from the same registry, got %r" % (lock,))
        self._reg = reg
        self.name = name
        self._lock = lock
        self._cond = threading.Condition(lock._lk)

    def acquire(self, blocking=True, timeout=-1):
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def wait(self, timeout=None):
        reg = self._reg
        if reg._hot or getattr(reg._tls, "held", None):
            return reg._cond_wait(self, timeout)
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def __repr__(self):
        return "<SanitizedCondition %r>" % self.name


class LockRegistry:
    """Named-lock registry + the sanitizer state machine.

    One process-wide default instance (:func:`registry`) carries the
    fleet's locks; tests seed private instances for mutation cases so
    deliberate inversions never pollute the default graph."""

    def __init__(self):
        # meta guards registry/graph/findings bookkeeping.  It is NEVER
        # held across a user-lock acquire, so it cannot deadlock
        # against the locks it watches.
        self._meta = threading.RLock()
        self._tls = threading.local()
        self._active = False
        self._hot = False           # _active or delays armed
        self._names = {}            # name -> {"level", "allow_blocking"}
        self._order = {}            # level -> rank (ordered chain)
        self._leaf = set()          # leaf-only level names
        self.graph = LockOrderGraph()
        self._findings = []
        self._finding_keys = set()
        self._delays = []           # [{"lock","seconds","times"}]
        self._saved = []            # (obj, attr, had_own, orig) patches
        self._orig_sleep = time.sleep

    # -- registration ------------------------------------------------------
    def _register(self, name, level, allow_blocking):
        with self._meta:
            rec = self._names.setdefault(
                name, {"level": None, "allow_blocking": False})
            if level is not None:
                if rec["level"] is not None and rec["level"] != level:
                    raise ValueError(
                        "lock %r already registered at level %r, cannot "
                        "re-register at %r" % (name, rec["level"], level))
                rec["level"] = level
            if allow_blocking:
                rec["allow_blocking"] = True

    def named_lock(self, name, level=None, allow_blocking=False):
        """A named non-reentrant lock.  `level` places it in the
        declared hierarchy; `allow_blocking` marks a lock that
        legitimately serializes blocking I/O (the sanitizer skips
        blocking-under-lock when it is the only/innermost hold, but
        still checks ordering)."""
        self._register(name, level, allow_blocking)
        return SanitizedLock(self, name)

    def named_rlock(self, name, level=None, allow_blocking=False):
        self._register(name, level, allow_blocking)
        return SanitizedRLock(self, name)

    def named_condition(self, name, lock=None, level=None):
        """A named condition.  Pass `lock` to share an already-
        registered sanitized lock (the engine's work-available condition
        shares the engine lock); otherwise an RLock is created under the
        same name."""
        self._register(name, level, False)
        return SanitizedCondition(self, name, lock=lock)

    def declare_hierarchy(self, levels, leaf=()):
        """Declare the partial order: `levels` is the ordered
        acquisition chain (earlier levels are acquired FIRST; a holder
        may only acquire same-or-later levels).  `leaf` levels are
        leaf-only: holding one while acquiring ANY registered lock is a
        violation."""
        with self._meta:
            self._order = {lvl: i for i, lvl in enumerate(levels)}
            self._leaf = set(leaf)

    def level_of(self, name):
        rec = self._names.get(name)
        return rec["level"] if rec else None

    def _allows_blocking(self, name):
        rec = self._names.get(name)
        return bool(rec and rec["allow_blocking"])

    # -- enable / disable --------------------------------------------------
    def enable(self, blocking=True, signal_check=True):
        """Arm the sanitizer: record acquisitions, check order +
        hierarchy, and (with `blocking`) patch the stdlib blocking seams
        and `signal.signal`."""
        with self._meta:
            if self._active:
                return self
            if blocking:
                self._install_patches(signal_check)
            self._active = True
            self._hot = True
        return self

    def disable(self):
        with self._meta:
            if not self._active:
                return
            self._active = False
            self._hot = bool(self._delays)
            self._uninstall_patches()

    @contextmanager
    def sanitizing(self, blocking=True, signal_check=True):
        self.enable(blocking=blocking, signal_check=signal_check)
        try:
            yield self
        finally:
            self.disable()

    @contextmanager
    def sanctioned(self):
        """Mark the calling thread's blocking as intentional (fault
        injection widening a race window, drills stalling on purpose) —
        the blocking-under-lock check skips it."""
        tls = self._tls
        tls.sanctioned = getattr(tls, "sanctioned", 0) + 1
        try:
            yield
        finally:
            tls.sanctioned -= 1

    # -- findings ----------------------------------------------------------
    def findings(self):
        with self._meta:
            return list(self._findings)

    def clear_findings(self):
        with self._meta:
            self._findings = []
            self._finding_keys = set()

    def reset(self):
        """Fresh graph + findings + delays (drill isolation)."""
        with self._meta:
            self.graph.clear()
            self._findings = []
            self._finding_keys = set()
            self._delays = []
            self._hot = self._active

    def assert_clean(self):
        fs = self.findings()
        if fs:
            raise AssertionError(
                "concurrency sanitizer found %d issue(s):\n%s"
                % (len(fs), "\n".join(d.format() for d in fs)))

    def _report(self, key, severity, code, message, var_names, provenance):
        with self._meta:
            if key in self._finding_keys:
                return
            self._finding_keys.add(key)
        d = Diagnostic(severity, code, message, var_names=var_names,
                       provenance=provenance,
                       pass_name="concurrency-sanitizer")
        with self._meta:
            self._findings.append(d)

    # -- fault-injection delays -------------------------------------------
    def install_delays(self, events):
        """Arm deterministic acquisition delays from `incubate.fault`
        ``lock_delay`` events: each ``{"lock": name, "seconds": s,
        "times": k}`` sleeps `s` (unsanitized original sleep) right
        after the named lock's next `k` acquisitions — widening a race
        window on purpose without touching product code."""
        with self._meta:
            for e in events:
                self._delays.append({
                    "lock": str(e.get("lock", "")),
                    "seconds": float(e.get("seconds", 0.0)),
                    "times": int(e.get("times", 1)),
                })
            self._hot = self._active or bool(self._delays)

    def clear_delays(self):
        with self._meta:
            self._delays = []
            self._hot = self._active

    def _maybe_delay(self, lk):
        hit = 0.0
        with self._meta:
            for d in self._delays:
                if d["lock"] == lk.name and d["times"] > 0:
                    d["times"] -= 1
                    hit = d["seconds"]
                    break
        if hit:
            self._orig_sleep(hit)

    # -- the acquisition path ---------------------------------------------
    def _acquire(self, lk, blocking=True, timeout=-1):
        tls = self._tls
        held = getattr(tls, "held", None)
        if held is None:
            held = tls.held = []
        for e in held:
            if e.lock is lk:            # re-entrant re-acquire: no checks
                got = lk._lk.acquire(blocking, timeout)
                if got:
                    e.count += 1
                return got
        active = self._active
        acq_stack = _capture_stack() if active else []
        if active:
            if getattr(tls, "in_handler", 0) and not lk.reentrant:
                self._report(
                    ("signal-unsafe-lock", lk.name), "error",
                    "signal-unsafe-lock",
                    "non-reentrant lock %r acquired inside a signal "
                    "handler — if the signal lands while this thread "
                    "already holds it, the handler deadlocks against "
                    "its own thread (use an RLock or defer to a "
                    "worker)" % lk.name,
                    var_names=(lk.name,),
                    provenance=["acquired in handler at:"]
                    + _indent(acq_stack))
            if held:
                self._check_order(lk, held, acq_stack)
        # checks happen BEFORE the raw acquire so a real inversion is
        # reported even if this very acquisition is the one that hangs
        got = lk._lk.acquire(blocking, timeout)
        if not got:
            return got
        e = _Held()
        e.lock = lk
        e.count = 1
        e.stack = acq_stack
        held.append(e)
        if self._delays:
            self._maybe_delay(lk)
        return True

    def _check_order(self, lk, held, acq_stack):
        new_level = self.level_of(lk.name)
        new_rank = self._order.get(new_level)
        with self._meta:
            for e in held:
                hname = e.lock.name
                if hname == lk.name:
                    continue
                cycle = self.graph.add_edge(hname, lk.name,
                                            e.stack, acq_stack)
                if cycle and len(cycle) > 1:
                    self._report_inversion(hname, lk.name, e, acq_stack,
                                           cycle)
                h_level = self.level_of(hname)
                if h_level in self._leaf:
                    self._report(
                        ("lock-hierarchy-leaf", hname, lk.name), "error",
                        "lock-hierarchy",
                        "lock %r (leaf level %r) held while acquiring "
                        "%r — leaf levels must not hold across any "
                        "other registered lock" % (hname, h_level,
                                                   lk.name),
                        var_names=(hname, lk.name),
                        provenance=["holding %r at:" % hname]
                        + _indent(e.stack)
                        + ["acquiring %r at:" % lk.name]
                        + _indent(acq_stack))
                elif (new_rank is not None and h_level in self._order
                      and self._order[h_level] > new_rank):
                    self._report(
                        ("lock-hierarchy", hname, lk.name), "error",
                        "lock-hierarchy",
                        "acquiring %r (level %r) while holding %r "
                        "(level %r) inverts the declared hierarchy "
                        "%s" % (lk.name, new_level, hname, h_level,
                                " -> ".join(sorted(
                                    self._order, key=self._order.get))),
                        var_names=(hname, lk.name),
                        provenance=["holding %r at:" % hname]
                        + _indent(e.stack)
                        + ["acquiring %r at:" % lk.name]
                        + _indent(acq_stack))

    def _report_inversion(self, hname, aname, held_entry, acq_stack, cycle):
        # the reverse path's first edge carries the historical stacks
        info = self.graph.edge(cycle[0], cycle[1]) or {}
        prov = ["previously observed order: " + " -> ".join(cycle),
                "  holding %r at:" % cycle[0]]
        prov += _indent(info.get("held_stack") or info.get("where_stack"))
        if info.get("where"):
            prov.append("  (static edge from %s)" % info["where"])
        prov += ["  acquiring %r at:" % cycle[1]]
        prov += _indent(info.get("acq_stack"))
        prov += ["conflicting order: %s -> %s" % (hname, aname),
                 "  holding %r at:" % hname]
        prov += _indent(held_entry.stack)
        prov += ["  acquiring %r at:" % aname]
        prov += _indent(acq_stack)
        self._report(
            ("lock-order-inversion",) + tuple(sorted((hname, aname))),
            "error", "lock-order-inversion",
            "acquiring %r while holding %r, but the reverse order (%s) "
            "was already observed — AB/BA inversion, a potential "
            "deadlock" % (aname, hname, " -> ".join(cycle)),
            var_names=(hname, aname), provenance=prov)

    def _release(self, lk):
        held = getattr(self._tls, "held", None)
        if held:
            for i in range(len(held) - 1, -1, -1):
                e = held[i]
                if e.lock is lk:
                    e.count -= 1
                    if e.count == 0:
                        del held[i]
                    break
        lk._lk.release()

    def _cond_wait(self, cond, timeout):
        tls = self._tls
        held = getattr(tls, "held", None)
        entry = None
        if held:
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is cond._lock:
                    entry = held[i]
                    del held[i]
                    break
        # waiting releases the condition's own lock; blocking-under-lock
        # applies only to OTHER registered locks still held
        if self._active and timeout is None:
            self._note_blocking("threading.Condition.wait")
        try:
            return cond._cond.wait(timeout)
        finally:
            if entry is not None:
                held.append(entry)

    def held_names(self):
        """Names of registered locks the calling thread holds,
        outermost first (drill assertions / debugging)."""
        return [e.lock.name for e in getattr(self._tls, "held", ())]

    # -- blocking-under-lock ----------------------------------------------
    def _note_blocking(self, api):
        if not self._active:
            return
        tls = self._tls
        if getattr(tls, "sanctioned", 0):
            return
        held = getattr(tls, "held", None)
        if not held:
            return
        blockers = [e for e in held
                    if not self._allows_blocking(e.lock.name)]
        if not blockers:
            return
        inner = blockers[-1]
        here = _capture_stack()
        self._report(
            ("blocking-under-lock", api, inner.lock.name,
             here[0] if here else ""),
            "warning", "blocking-under-lock",
            "%s called while holding registered lock %r — an unbounded "
            "block under a lock is the requeue-deadlock shape; use a "
            "timeout or move the call outside the lock"
            % (api, inner.lock.name),
            var_names=tuple(e.lock.name for e in blockers),
            provenance=["holding %r at:" % inner.lock.name]
            + _indent(inner.stack)
            + ["blocking call at:"] + _indent(here))

    # -- stdlib patches ----------------------------------------------------
    def _patch(self, obj, attr, fn):
        had_own = attr in vars(obj) if isinstance(obj, type) else True
        orig = getattr(obj, attr)
        self._saved.append((obj, attr, had_own, orig))
        setattr(obj, attr, fn)
        return orig

    def _install_patches(self, signal_check):
        global _PATCHED_BY
        if _PATCHED_BY is not None and _PATCHED_BY is not self:
            raise RuntimeError(
                "blocking patches already installed by another "
                "LockRegistry; disable it first")
        _PATCHED_BY = self
        import queue
        import signal as signal_mod
        import socket
        import subprocess
        reg = self

        orig_sleep = self._patch(
            time, "sleep",
            lambda secs: (reg._note_blocking("time.sleep"),
                          reg._orig_sleep(secs))[1])
        self._orig_sleep = orig_sleep

        orig_get = queue.Queue.get

        def _get(q, block=True, timeout=None):
            if block and timeout is None:
                reg._note_blocking("queue.Queue.get")
            return orig_get(q, block, timeout)
        self._patch(queue.Queue, "get", _get)

        orig_ewait = threading.Event.wait
        # Thread.start() waits on the new thread's _started event with
        # no timeout — that handshake is bounded by the scheduler, not
        # by any lock, so it is not the requeue-deadlock shape.
        start_code = threading.Thread.start.__code__

        def _ewait(ev, timeout=None):
            if (timeout is None
                    and sys._getframe(1).f_code is not start_code):
                reg._note_blocking("threading.Event.wait")
            return orig_ewait(ev, timeout)
        self._patch(threading.Event, "wait", _ewait)

        orig_pwait = subprocess.Popen.wait

        def _pwait(p, timeout=None):
            if timeout is None:
                reg._note_blocking("subprocess.Popen.wait")
            return orig_pwait(p, timeout)
        self._patch(subprocess.Popen, "wait", _pwait)

        orig_comm = subprocess.Popen.communicate

        def _comm(p, input=None, timeout=None):
            if timeout is None:
                reg._note_blocking("subprocess.Popen.communicate")
            return orig_comm(p, input=input, timeout=timeout)
        self._patch(subprocess.Popen, "communicate", _comm)

        for sock_api in ("recv", "sendall", "accept"):
            orig_sock = getattr(socket.socket, sock_api)

            def _sock(s, *a, _orig=orig_sock, _api=sock_api, **k):
                reg._note_blocking("socket.socket.%s" % _api)
                return _orig(s, *a, **k)
            self._patch(socket.socket, sock_api, _sock)

        orig_read = os.read
        self._patch(os, "read",
                    lambda fd, n: (reg._note_blocking("os.read"),
                                   orig_read(fd, n))[1])
        orig_write = os.write
        self._patch(os, "write",
                    lambda fd, b: (reg._note_blocking("os.write"),
                                   orig_write(fd, b))[1])

        if signal_check:
            orig_signal = signal_mod.signal

            def _signal(sig, handler):
                if callable(handler):
                    def wrapped(signum, frame, _h=handler):
                        tls = reg._tls
                        tls.in_handler = getattr(tls, "in_handler", 0) + 1
                        try:
                            return _h(signum, frame)
                        finally:
                            tls.in_handler -= 1
                    wrapped.__wrapped__ = handler
                    return orig_signal(sig, wrapped)
                return orig_signal(sig, handler)
            self._patch(signal_mod, "signal", _signal)

    def _uninstall_patches(self):
        global _PATCHED_BY
        while self._saved:
            obj, attr, had_own, orig = self._saved.pop()
            if had_own:
                setattr(obj, attr, orig)
            else:
                # the patch shadowed an inherited (C-base) method
                try:
                    delattr(obj, attr)
                except AttributeError:      # pragma: no cover
                    pass
        if _PATCHED_BY is self:
            _PATCHED_BY = None
        self._orig_sleep = time.sleep


# ---------------------------------------------------------------------------
# the process-wide default registry
# ---------------------------------------------------------------------------

_default = LockRegistry()
# the fleet hierarchy (documented in README "Concurrency analysis"):
# router-layer locks are acquired first, engine-layer last; tracer and
# metrics locks are leaves — they never hold across another lock
_default.declare_hierarchy(("router", "registry", "replica", "engine"),
                           leaf=("tracer", "metrics"))


def registry():
    """The process-wide default :class:`LockRegistry`."""
    return _default


def named_lock(name, level=None, allow_blocking=False):
    return _default.named_lock(name, level=level,
                               allow_blocking=allow_blocking)


def named_rlock(name, level=None, allow_blocking=False):
    return _default.named_rlock(name, level=level,
                                allow_blocking=allow_blocking)


def named_condition(name, lock=None, level=None):
    return _default.named_condition(name, lock=lock, level=level)


def declare_hierarchy(levels, leaf=()):
    _default.declare_hierarchy(levels, leaf=leaf)


def enable(blocking=True, signal_check=True):
    return _default.enable(blocking=blocking, signal_check=signal_check)


def disable():
    _default.disable()


def sanitizing(blocking=True, signal_check=True):
    return _default.sanitizing(blocking=blocking, signal_check=signal_check)


def sanctioned():
    """Sanctioned-blocking context on whichever registry owns the
    process patches (the default one otherwise)."""
    return (_PATCHED_BY or _default).sanctioned()


def findings():
    return _default.findings()


def clear_findings():
    _default.clear_findings()


def assert_clean():
    _default.assert_clean()


def install_delays(events):
    _default.install_delays(events)


def clear_delays():
    _default.clear_delays()
