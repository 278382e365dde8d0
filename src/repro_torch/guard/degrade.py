"""Graceful degradation for the serving path (guard layer 5).

The port of ``repro.guard.degrade``.

A view refresh that fails once is retried with exponential backoff +
jitter; a view that fails *repeatedly* trips a per-view circuit breaker
and degrades to serving its **last-good snapshot** with an explicit
staleness bound, instead of blocking the request path behind a broken
refresh.  After ``breaker_reset`` seconds the breaker goes half-open
and lets one refresh probe through; success closes it and fresh serving
resumes.

Everything here is clock/sleep-injectable so the breaker state machine
unit-tests with a fake clock, and :class:`GuardedView` is duck-typed
over anything exposing ``submit_head_update`` / ``flush`` / ``logits``
(in practice
:class:`repro_torch.serve.incremental_views.IncrementalLogitView`).

The reference's last-good snapshot is a reference to an immutable logits
array.  The port's view engine updates its views in place, so a
reference to its logits would be the live view.  :class:`GuardedView`
therefore makes the engine of a view it wraps write out of place (its
dense applies through the out-of-place kernel entry, its row-local
views copied before a row apply): then no flush writes a tensor that
existed before it, and the snapshot stays a reference, free, that no
later flush moves.  The price is memory: the snapshot's logits stay
alive beside the live ones once a flush has replaced them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np


@dataclass(frozen=True)
class DegradePolicy:
    """Retry/backoff/breaker knobs for one serving view."""

    max_retries: int = 3          # attempts per refresh (1 + retries)
    backoff_base: float = 0.01    # first retry delay, seconds
    backoff_max: float = 1.0      # delay cap
    jitter: float = 0.5           # ± fraction of the delay randomized
    #: AWS-style "full jitter": each sleep is uniform(0, delay) instead
    #: of delay·(1 ± jitter).  A fleet of workers retrying the same
    #: failure decorrelates completely — reclaim storms cannot
    #: synchronize into periodic thundering herds (the ±-fraction mode
    #: keeps them within ``jitter`` of lock-step).
    full_jitter: bool = False
    #: total wall-clock budget for one retried call, seconds (None =
    #: attempts-bounded only).  Enforced against the injected ``clock``,
    #: so a lease-holding fleet worker can bound its retry loop well
    #: under the lease TTL instead of retrying into a fencing conflict.
    retry_deadline: Optional[float] = None
    breaker_threshold: int = 3    # consecutive exhausted refreshes → open
    breaker_reset: float = 30.0   # seconds open → half-open probe
    seed: int = 0


class CircuitBreaker:
    """closed → (threshold consecutive failures) → open → (reset
    timeout) → half_open → one probe → closed | open."""

    def __init__(self, threshold: int = 3, reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_started: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.reset_timeout:
            return "half_open"
        return "open"

    @property
    def consecutive_failures(self) -> int:
        return self._failures

    def allow(self) -> bool:
        """May a refresh be attempted now?  half_open admits exactly ONE
        in-flight probe — concurrent callers (a fleet of workers all
        watching the same broken tenant) see the window as still open
        instead of stampeding the backend together.  A probe whose
        caller vanished (crashed worker) is abandoned after another
        ``reset_timeout``, re-arming the window."""
        if self.state != "half_open":
            return self.state == "closed"
        now = self._clock()
        if (self._probe_started is not None
                and now - self._probe_started < self.reset_timeout):
            return False  # someone else's probe is in flight
        self._probe_started = now
        return True

    def record_success(self) -> None:
        self._failures = 0
        self._opened_at = None
        self._probe_started = None

    def record_failure(self) -> None:
        self._failures += 1
        self._probe_started = None
        if self._failures >= self.threshold or self._opened_at is not None:
            self._opened_at = self._clock()


def retry_with_backoff(fn: Callable[[], object], policy: DegradePolicy,
                       rng: np.random.Generator,
                       sleep: Callable[[float], None] = time.sleep,
                       clock: Callable[[], float] = time.monotonic):
    """Call ``fn`` up to ``1 + max_retries`` times with exponential
    backoff + jitter between attempts.  Returns ``(value, attempts)``;
    re-raises the last exception when every attempt failed.

    The injected ``clock``/``sleep`` pair makes the loop fully
    deterministic under a fake clock (fleet tests, chaos runs).  With
    ``policy.retry_deadline`` set, the loop also gives up once the next
    sleep would land past the deadline — a lease-holding worker must
    fail fast and let the claim be reclaimed, not retry through its own
    TTL.  ``policy.full_jitter`` draws each sleep uniform(0, delay)
    (decorrelated) instead of delay·(1 ± jitter).
    """
    t0 = clock()
    delay = policy.backoff_base
    last: Optional[BaseException] = None
    for attempt in range(1 + policy.max_retries):
        try:
            return fn(), attempt + 1
        except Exception as e:  # noqa: BLE001 — the whole point is containment
            last = e
            if attempt == policy.max_retries:
                break
            if policy.full_jitter:
                pause = min(delay, policy.backoff_max) * rng.random()
            else:
                jit = 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
                pause = min(delay * jit, policy.backoff_max)
            if (policy.retry_deadline is not None
                    and clock() - t0 + pause > policy.retry_deadline):
                break
            sleep(pause)
            delay = min(delay * 2.0, policy.backoff_max)
    raise last  # type: ignore[misc]


class GuardedView:
    """Wraps one incremental logit view with retries, a circuit breaker,
    and a last-good snapshot fallback.

    The snapshot is refreshed after every successful flush (a reference
    to the logits tensor, which the view's out-of-place engine never
    writes again — free).  While the breaker is open,
    :meth:`read` serves the snapshot and reports its staleness; deltas
    submitted meanwhile still enqueue (they are host-side and cheap), so
    a recovered view flushes the full backlog and is exact again.
    """

    def __init__(self, view, policy: Optional[DegradePolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.view = view
        engine = getattr(view, "engine", None)
        if engine is not None:
            # the snapshot below is a reference: no later flush may write
            # the tensor it holds
            engine._write_out_of_place()
        self.policy = policy or DegradePolicy()
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(self.policy.seed)
        self.breaker = CircuitBreaker(self.policy.breaker_threshold,
                                      self.policy.breaker_reset, clock)
        self._snapshot = None
        self._snapshot_time: Optional[float] = None
        self.last_error: Optional[str] = None
        self.retries_used = 0
        self.refresh_failures = 0
        self.degraded_reads = 0
        self._snapshot_now()

    # -- internals -----------------------------------------------------------
    def _snapshot_now(self) -> None:
        self._snapshot = self.view.logits
        self._snapshot_time = self._clock()

    def _guarded(self, fn: Callable[[], object]) -> bool:
        """Run one refresh through retry + breaker; True on success."""
        if not self.breaker.allow():
            return False
        try:
            _, attempts = retry_with_backoff(fn, self.policy, self._rng,
                                             sleep=self._sleep,
                                             clock=self._clock)
        except Exception as e:  # noqa: BLE001
            self.refresh_failures += 1
            self.last_error = repr(e)
            self.breaker.record_failure()
            return False
        self.retries_used += attempts - 1
        self.breaker.record_success()
        self.last_error = None
        self._snapshot_now()
        return True

    # -- the serving contract ------------------------------------------------
    def submit(self, u, v) -> bool:
        """Queue one hot-swap delta.  Enqueueing is host-side and always
        succeeds; the *flush* it may trip is the guarded part.  Returns
        True when the view's logits are fresh after this call."""
        if not self.breaker.allow():
            # refreshes are suspended: enqueue without flushing so the
            # open breaker is not hammered by every delta
            self.view.engine.enqueue_update("W", u, v) \
                if hasattr(self.view, "engine") else None
            return False
        return self._guarded(lambda: self.view.submit_head_update(u, v))

    def flush(self) -> bool:
        """Force pending deltas into the view (retried, breaker-gated).
        Returns True when the view is fresh, False when degraded."""
        return self._guarded(self.view.flush)

    def read(self):
        """Logits at bounded staleness: fresh when the view is healthy,
        the last-good snapshot when the breaker is open (counted in
        ``degraded_reads``; staleness surfaced via :meth:`health`)."""
        if self.flush():
            return self.view.logits
        self.degraded_reads += 1
        return self._snapshot

    def staleness(self) -> float:
        """Seconds since the served snapshot was known good (0 when
        serving fresh)."""
        if self.breaker.state == "closed":
            return 0.0
        if self._snapshot_time is None:
            return float("inf")
        return self._clock() - self._snapshot_time

    def health(self) -> Dict[str, object]:
        return {
            "breaker": self.breaker.state,
            "serving": ("snapshot" if self.breaker.state == "open"
                        else "fresh"),
            "staleness_s": self.staleness(),
            "consecutive_failures": self.breaker.consecutive_failures,
            "refresh_failures": self.refresh_failures,
            "retries_used": self.retries_used,
            "degraded_reads": self.degraded_reads,
            "pending_updates": getattr(self.view, "pending_updates", 0),
            "last_error": self.last_error,
        }
