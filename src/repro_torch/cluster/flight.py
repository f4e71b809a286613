"""Single-flight miss deduplication.

When several threads miss on the *same* cold signature concurrently, only
the first (the **leader**) executes the backend; the rest (**followers**)
block on the leader's :class:`Flight` and receive the identical result table
— one scan instead of K racing scans for a popular cold dashboard tile.

A flight is registered under the owning shard's lock at lookup time (the
miss check and the registration are one atomic step, so two threads can
never both become leader), and resolved outside any lock: the leader calls
``complete``/``fail`` through the shard after executing, and followers
``wait`` with a timeout and fall back to executing themselves if the leader
died or aborted — dedup is an optimization, never a correctness dependency.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from ..analysis.sanitizer import note_blocking

if TYPE_CHECKING:  # pragma: no cover
    from ..core.table import ResultTable
    from .shard import CacheShard

DEFAULT_FLIGHT_TIMEOUT_S = 30.0


class Flight:
    """One in-flight miss computation, shared by a leader and its followers."""

    __slots__ = ("key", "shard", "table", "error", "obs_ctx", "_event")

    def __init__(self, key: str, shard: "CacheShard"):
        self.key = key
        self.shard = shard
        # resolved exactly once through the owning shard's complete_flight /
        # fail_flight, which hold the shard lock; read by followers only
        # after the event is set (publication happens-before the wait)
        self.table: Optional["ResultTable"] = None  # guarded-by: self.shard.lock
        self.error: Optional[BaseException] = None  # guarded-by: self.shard.lock
        # the sampled leader's trace context (Trace, span_id): written only
        # by the leader before it resolves the flight, read by followers
        # after wait() returns — the event publication orders the accesses
        self.obs_ctx: Optional[tuple] = None  # guarded-by: external[leader-writes-before-event, followers read after wait()]
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        return self._event.is_set() and self.error is None

    def wait(self, timeout: Optional[float] = DEFAULT_FLIGHT_TIMEOUT_S) -> bool:
        """Block until the leader resolves the flight; False on timeout.

        A follower must never wait while holding a lock the leader needs to
        resolve the flight (the leader stores + completes under the shard
        lock) — the sanitizer's blocking-call check enforces that."""
        note_blocking("Flight.wait")
        return self._event.wait(timeout)

    # resolution happens through the owning shard (shard.complete_flight /
    # shard.fail_flight) so deregistration and result publication stay under
    # one lock; these setters are the shard-internal halves.
    def _resolve(self, table: Optional["ResultTable"],
                 error: Optional[BaseException]) -> None:  # requires-lock: self.shard.lock
        self.table = table
        self.error = error
        self._event.set()
