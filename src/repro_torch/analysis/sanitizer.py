"""Runtime lock-order sanitizer (opt-in via ``REPRO_SANITIZE=1``).

The static lock-order pass (``lockorder.py``) proves acyclicity of the
acquisition graph it can *see*; this module checks the orders that actually
happen.  Production modules create their locks through :func:`make_lock`,
which normally returns a plain ``threading.Lock``/``RLock``.  With
``REPRO_SANITIZE=1`` in the environment it returns a :class:`SanitizedLock`
that, on every acquisition, records the edge (held lock class -> acquiring
lock class) into a global observed-order digraph and raises
:class:`LockOrderViolation` the moment an acquisition would close a cycle —
i.e. the moment two threads have demonstrated opposite acquisition orders,
which is a latent deadlock even if this particular run never interleaved
into one.

Granularity is the **lock class** (the ``order_class`` string passed to
``make_lock``, e.g. ``"CacheShard.lock"``), not the instance: a deadlock
between two shard locks is an ordering bug of the class, and per-instance
graphs would miss the A-instance-1 -> B vs B -> A-instance-2 interleaving.
Two escapes keep that sound in practice:

* re-entrant acquisition of the *same instance* (RLock semantics) never
  records an edge;
* classes registered via :func:`allow_same_class_order` may nest instances
  of themselves (the cluster rebalance acquires every shard lock, in shard
  order, while holding the topology lock).

``note_blocking(what)`` is the held-lock-across-blocking-call check:
instrumented blocking points (``Flight.wait``, the tenant read/write gate
acquisitions) call it, and it raises if the calling thread still holds any
sanitized lock — waiting on another thread's progress while holding a lock
that thread may need is the other classic deadlock shape.

Violations both raise in the offending thread *and* are recorded in a
global list (``violations()``), because test harnesses often swallow worker
thread exceptions.  All sanitizer state is process-global and reset via
:func:`reset` (tests).  This module must stay import-light: production hot
paths import it unconditionally.
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Union

__all__ = [
    "LockOrderViolation", "SanitizedLock", "make_lock", "sanitize_enabled",
    "note_blocking", "note_acquire", "note_release", "violations", "reset",
    "allow_same_class_order", "observed_edges",
]

ENV_FLAG = "REPRO_SANITIZE"


def sanitize_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0", "false", "no")


class LockOrderViolation(AssertionError):
    """A demonstrated lock-order cycle or a blocking call under a held lock."""


class _State:
    """Process-global sanitizer state.  Its own plain lock is deliberately
    *not* sanitized (it is a leaf acquired for bookkeeping only)."""

    def __init__(self):
        self.lock = threading.Lock()
        # observed order digraph over lock classes: class -> set of classes
        # acquired while it was held, plus the first witness per edge
        self.edges: dict[str, set[str]] = {}
        self.witness: dict[tuple[str, str], str] = {}
        self.allowed_self: set[str] = set()
        self.violations: list[str] = []
        self.tls = threading.local()

    def held_stack(self) -> list:
        st = getattr(self.tls, "stack", None)
        if st is None:
            st = self.tls.stack = []
        return st


_STATE = _State()


def reset() -> None:
    """Forget all observed edges, violations, and self-order allowances
    (held stacks are thread-local and drain naturally)."""
    with _STATE.lock:
        _STATE.edges.clear()
        _STATE.witness.clear()
        _STATE.violations.clear()
        _STATE.allowed_self.clear()


def allow_same_class_order(order_class: str) -> None:
    """Permit nesting several *instances* of one lock class (the caller
    vouches for a deterministic instance order, e.g. shard-index order)."""
    with _STATE.lock:
        _STATE.allowed_self.add(order_class)


def violations() -> list[str]:
    with _STATE.lock:
        return list(_STATE.violations)


def observed_edges() -> dict[str, set[str]]:
    with _STATE.lock:
        return {k: set(v) for k, v in _STATE.edges.items()}


def _record(msg: str) -> None:
    with _STATE.lock:
        _STATE.violations.append(msg)


def _reaches(src: str, dst: str) -> Optional[list[str]]:
    """DFS: path src -> dst in the observed digraph (caller holds state
    lock).  Returns the class path or None."""
    stack = [(src, [src])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in _STATE.edges.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _on_acquired(lock: "SanitizedLock") -> None:
    """Called after the underlying lock is held: record edges from every
    currently-held lock class and check for order cycles."""
    stack = _STATE.held_stack()
    for held in stack:
        a, b = held.order_class, lock.order_class
        if a == b:
            if held is lock:
                continue  # re-entrant same-instance: RLock semantics
            with _STATE.lock:
                allowed = a in _STATE.allowed_self
            if not allowed:
                msg = (f"lock-order: nested acquisition of two {a!r} "
                       f"instances (not registered as self-ordered)")
                _record(msg)
                raise LockOrderViolation(msg)
            continue
        msg = None
        with _STATE.lock:
            if b in _STATE.edges.get(a, ()):
                continue  # edge already known consistent
            back = _reaches(b, a)
            if back is not None:
                first = _STATE.witness.get((back[0], back[1]), "?")
                msg = (f"lock-order cycle: acquiring {b!r} while holding "
                       f"{a!r}, but the opposite order "
                       f"{' -> '.join(back)} was observed (first witness: "
                       f"{first})")
                _STATE.violations.append(msg)
            else:
                _STATE.edges.setdefault(a, set()).add(b)
                _STATE.witness[(a, b)] = _thread_site()
        if msg is not None:
            raise LockOrderViolation(msg)
    stack.append(lock)


def _thread_site() -> str:
    return f"thread={threading.current_thread().name}"


def _on_released(lock: "SanitizedLock") -> None:
    stack = _STATE.held_stack()
    # remove the most recent entry for this instance (release order may not
    # be perfectly LIFO across instances)
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is lock:
            del stack[i]
            return


class SanitizedLock:
    """Drop-in for ``threading.Lock``/``RLock`` that reports acquisition
    edges to the global order graph.  Re-entrancy is backed by a real RLock;
    non-reentrant use sites simply never re-enter."""

    __slots__ = ("order_class", "_inner", "_depth_tls")

    def __init__(self, order_class: str, reentrant: bool = True):
        self.order_class = order_class
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._depth_tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._depth_tls, "d", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._depth() == 0 and blocking and timeout == -1:
            # a contended blocking acquire is itself a wait-for edge; the
            # edge recording below covers it (cycle == potential deadlock)
            pass
        got = self._inner.acquire(blocking, timeout)
        if got:
            if self._depth() == 0:
                try:
                    _on_acquired(self)
                except BaseException:
                    self._inner.release()
                    raise
            self._depth_tls.d = self._depth() + 1
        return got

    def release(self) -> None:
        d = self._depth()
        self._inner.release()
        self._depth_tls.d = d - 1
        if d == 1:
            _on_released(self)

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:  # Lock-protocol compatibility
        return self._depth() > 0


LockLike = Union["SanitizedLock", "threading.Lock", "threading.RLock"]


def make_lock(order_class: str, *, reentrant: bool = False) -> LockLike:
    """The production lock factory.  Plain ``threading`` primitive normally;
    a :class:`SanitizedLock` of the given order class under
    ``REPRO_SANITIZE=1``.  ``order_class`` is the class-qualified attribute
    name (``"CacheShard.lock"``) — the same identifier the static lock-order
    pass uses, so static edges and runtime edges line up."""
    if sanitize_enabled():
        return SanitizedLock(order_class, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()


# --------------------------------------------------------- manual bookkeeping
class _Pseudo:
    """A pseudo-lock entry for constructs that are not mutexes but impose
    ordering (the tenant read/write gate): note_acquire/note_release push and
    pop it on the held stack so edges through it are observed.  ``shared``
    marks read-side acquisitions: many holders at once, so holding one across
    a blocking wait cannot starve the thread being waited on."""

    __slots__ = ("order_class", "shared")

    def __init__(self, order_class: str, shared: bool = False):
        self.order_class = order_class
        self.shared = shared


def note_acquire(order_class: str, *, shared: bool = False) -> Optional[_Pseudo]:
    """Record a non-mutex acquisition (returns a token for note_release).
    No-op (None) when sanitizing is off."""
    if not sanitize_enabled():
        return None
    token = _Pseudo(order_class, shared=shared)
    _on_acquired(token)  # type: ignore[arg-type]
    return token


def note_release(token: Optional[_Pseudo]) -> None:
    if token is not None:
        _on_released(token)  # type: ignore[arg-type]


def note_blocking(what: str) -> None:
    """Assert the calling thread holds no sanitized lock while entering a
    blocking wait on another thread's progress.  No-op when sanitizing is
    off."""
    if not sanitize_enabled():
        return
    stack = [l for l in _STATE.held_stack()
             if not getattr(l, "shared", False)]
    if stack:
        held = [l.order_class for l in stack]
        msg = (f"blocking call {what!r} while holding sanitized lock(s) "
               f"{held}: the thread being waited on may need them")
        _record(msg)
        raise LockOrderViolation(msg)
