"""Deterministic fault injection (guard layer 4).

The port of ``repro.guard.chaos``: host-side numpy with the reference's
seeded draw order, so one seed poisons and raises at the same firings in
both packages.  Only :meth:`ChaosMonkey.poison_update` knows torch: a
tensor factor is poisoned in a copy on its own device.

The recovery paths in this repo — quarantine, transactional rollback,
checkpoint-chain fallback, host eviction — are only trustworthy if they
are *exercised*, not merely written.  :class:`ChaosConfig` declares a
seeded fault mix and :class:`ChaosMonkey` threads it through the real
code paths:

  * ``poison_p``       — corrupt an incoming ``(u, v)`` update with
    NaN/Inf/huge entries before validation sees it
    (:class:`~repro_torch.core.runtime.IncrementalEngine`);
  * ``trigger_raise_p`` — raise :class:`ChaosError` inside a trigger
    firing, standing in for a kernel/device fault (the transactional
    layer must roll back);
  * ``corrupt_checkpoint_p`` — flip bytes in a just-written checkpoint
    payload (:class:`~repro_torch.dist.checkpoint.CheckpointManager`:
    checksum verification and chain fallback must catch it);
  * ``kill_host_p``    — permanently swallow a host's heartbeats
    (:class:`~repro_torch.dist.fault_tolerance.FaultTolerantController`:
    timeout eviction and the supervisor restart loop must recover);
  * ``worker_crash_p`` — kill a fleet refresh worker *between* firing
    and commit (:mod:`repro_torch.fleet`'s lease reclaim must roll back
    the uncommitted work and replay it from the tenant's update log);
  * ``lease_expiry_p`` — force-expire a worker's lease mid-claim (its
    commit must be fenced off and its work rolled back — the
    slow-worker-loses-the-race case, compressed);
  * ``slow_worker_p``  — stall a worker for ``slow_worker_s`` seconds
    inside its claim, so its lease expires *naturally* and reclaim +
    fencing race a still-running worker.

Every decision comes from one ``np.random.default_rng(seed)`` drawn in
call order, so a failing chaos run replays exactly under the same seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Set, Tuple

import numpy as np
import torch


class ChaosError(RuntimeError):
    """An injected fault (never raised by real failures)."""


@dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-injection mix; all probabilities default to off."""

    seed: int = 0
    poison_p: float = 0.0
    poison_kind: str = "nan"          # "nan" | "inf" | "huge"
    trigger_raise_p: float = 0.0
    corrupt_checkpoint_p: float = 0.0
    kill_host_p: float = 0.0
    worker_crash_p: float = 0.0       # fleet: die after firing, pre-commit
    lease_expiry_p: float = 0.0       # fleet: lease yanked mid-claim
    slow_worker_p: float = 0.0        # fleet: stall inside a claim …
    slow_worker_s: float = 0.0        # … for this many (injected) seconds

    def monkey(self) -> "ChaosMonkey":
        return ChaosMonkey(self)


class ChaosMonkey:
    """Stateful injector for one :class:`ChaosConfig` (owns the rng and
    the fault counters; construct one per run)."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._killed: Set[int] = set()
        self.poisoned = 0
        self.raises = 0
        self.corruptions = 0
        self.kills = 0
        self.worker_crashes = 0
        self.lease_expiries = 0
        self.slowdowns = 0

    # -- update poisoning ----------------------------------------------------
    def poison_update(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        """With probability ``poison_p``, corrupt one factor entry.

        ``"nan"``/``"inf"`` plant a non-finite entry (caught by the
        finite check); ``"huge"`` plants a finite ~1e38 entry whose
        outer product overflows f32 (caught by the norm budget or the
        post-firing output validation).  Always returns copies (host
        copies of arrays, copies of tensors on their device) so the
        caller's factors are never mutated.
        """
        cfg = self.config
        if cfg.poison_p <= 0 or self._rng.random() >= cfg.poison_p:
            return u, v
        u, v = _f32_copy(u), _f32_copy(v)
        side = u if self._rng.random() < 0.5 else v
        idx = (int(self._rng.integers(side.shape[0])),
               int(self._rng.integers(side.shape[1])))
        side[idx] = {"nan": np.nan, "inf": np.inf,
                     "huge": np.float32(1e38)}[cfg.poison_kind]
        self.poisoned += 1
        return u, v

    # -- trigger faults ------------------------------------------------------
    def maybe_raise_in_trigger(self) -> None:
        cfg = self.config
        if cfg.trigger_raise_p > 0 and self._rng.random() < cfg.trigger_raise_p:
            self.raises += 1
            raise ChaosError("injected trigger fault")

    # -- checkpoint corruption -----------------------------------------------
    def maybe_corrupt_checkpoint(self, payload_path: str) -> bool:
        """With probability ``corrupt_checkpoint_p``, XOR-flip a short
        byte run inside the payload file (past the zip header, so the
        archive still opens and only the array bytes are wrong — the
        realistic bit-rot case checksums exist for)."""
        cfg = self.config
        if (cfg.corrupt_checkpoint_p <= 0
                or self._rng.random() >= cfg.corrupt_checkpoint_p):
            return False
        size = os.path.getsize(payload_path)
        if size < 256:
            return False
        off = int(self._rng.integers(size // 2, size - 16))
        with open(payload_path, "r+b") as f:
            f.seek(off)
            chunk = bytearray(f.read(8))
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in chunk))
        self.corruptions += 1
        return True

    # -- host kills ----------------------------------------------------------
    def should_kill_host(self, host: int) -> bool:
        """Once killed, a host stays silent (its heartbeats are swallowed
        until :meth:`revive`), so the controller's timeout eviction sees a
        realistic permanent failure, not a flicker."""
        if host in self._killed:
            return True
        cfg = self.config
        if cfg.kill_host_p > 0 and self._rng.random() < cfg.kill_host_p:
            self._killed.add(host)
            self.kills += 1
            return True
        return False

    def revive(self, host: int) -> None:
        self._killed.discard(host)

    def killed_hosts(self) -> Set[int]:
        return set(self._killed)

    # -- fleet worker faults (fleet/) ----------------------------------------
    def should_crash_worker(self) -> bool:
        """Crash this worker NOW — after it fired but before it commits.

        The scheduler abandons the claim without releasing the lease
        (exactly what a dead process looks like to the lease store); the
        TTL expires, another worker reclaims, rolls the uncommitted
        firing back, and replays from the tenant's update log."""
        cfg = self.config
        if cfg.worker_crash_p > 0 and self._rng.random() < cfg.worker_crash_p:
            self.worker_crashes += 1
            return True
        return False

    def should_expire_lease(self) -> bool:
        """Yank the current claim's lease before its commit, so the
        commit hits the fencing check and the work is rolled back — the
        deterministic compression of a worker losing a TTL race."""
        cfg = self.config
        if cfg.lease_expiry_p > 0 and self._rng.random() < cfg.lease_expiry_p:
            self.lease_expiries += 1
            return True
        return False

    def slow_worker_delay(self) -> float:
        """Seconds to stall inside the claim (0.0 = healthy).  Injected
        through the scheduler's clock/sleep, so with a fake clock the
        stall is virtual but still long enough to expire the lease."""
        cfg = self.config
        if cfg.slow_worker_p > 0 and self._rng.random() < cfg.slow_worker_p:
            self.slowdowns += 1
            return float(cfg.slow_worker_s)
        return 0.0


def _f32_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return np.array(x, dtype=np.float32, copy=True)


def as_monkey(chaos: Optional[object]) -> Optional[ChaosMonkey]:
    """Accept a :class:`ChaosConfig`, a :class:`ChaosMonkey`, or None.

    Passing one *monkey* to several components (engine + checkpoint
    manager + controller) makes them share a draw sequence; passing the
    *config* gives each component its own independent seeded stream.
    """
    if chaos is None or isinstance(chaos, ChaosMonkey):
        return chaos
    if isinstance(chaos, ChaosConfig):
        return chaos.monkey()
    raise TypeError(f"chaos must be ChaosConfig | ChaosMonkey | None, "
                    f"got {type(chaos).__name__}")
