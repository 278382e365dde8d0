"""Fault tolerance control plane: detect, evict, replan, restart.

The port's own copy of the JAX package's ``dist/fault_tolerance.py``
(which imports no JAX itself, but its package does): the same phases,
events and messages, so one fake-clock script drives both controllers to
the same decisions.  Chaos goes through :mod:`repro_torch.guard`.

Three pieces, decoupled from the training framework so they unit-test
with a fake clock and drive any runner:

  * :class:`FaultTolerantController` — host liveness from heartbeats.
    A host is **failed** when its last heartbeat is older than
    ``heartbeat_timeout``; a host is a **straggler** when its reported
    step time exceeds ``straggler_factor ×`` the alive median for
    ``straggler_patience`` consecutive ticks (slow hardware stalls a
    synchronous mesh exactly like a dead host, just less honestly).
    Either eviction moves the run to ``RESHAPING``; dropping below
    ``min_hosts`` moves it to ``HALTED``.

  * :func:`plan_mesh` — elastic mesh replanning: given the surviving
    device count, produce the largest valid (data, model) — or
    (pod, data, model) — mesh shape, keeping model parallelism fixed
    (weights are sharded over it; resizing it would re-layout weights).

  * :class:`TrainingSupervisor` — the restart loop: run steps, save on
    a cadence, and on a reshape event restore from the newest checkpoint
    and continue on the surviving hosts.

State machine (documented in docs/dist.md):

    RUNNING --failure/straggler/rejoin--> RESHAPING --complete_reshape-->
    RUNNING;   RUNNING --alive < min_hosts--> HALTED (terminal until
    operator intervention).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class RunPhase(enum.Enum):
    RUNNING = "running"
    RESHAPING = "reshaping"
    HALTED = "halted"


@dataclass(frozen=True)
class FaultToleranceConfig:
    heartbeat_timeout: float = 30.0   # seconds of silence → failed
    straggler_factor: float = 0.0     # ×median step time; 0 disables
    straggler_patience: int = 3       # consecutive slow ticks → evicted
    min_hosts: int = 1                # fewer alive → HALTED


class FaultTolerantController:
    """Tracks host liveness; owns the RUNNING/RESHAPING/HALTED phase."""

    def __init__(self, n_hosts: int,
                 config: Optional[FaultToleranceConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None):
        self.config = config or FaultToleranceConfig()
        self._clock = clock
        self._chaos = None
        if chaos is not None:
            from ..guard.chaos import as_monkey
            self._chaos = as_monkey(chaos)
        now = clock()
        self._alive: Set[int] = set(range(n_hosts))
        self._last_seen: Dict[int, float] = {h: now for h in self._alive}
        self._step_time: Dict[int, float] = {}
        self._slow_ticks: Dict[int, int] = {}
        self.phase = RunPhase.RUNNING
        self.events: List[str] = []

    # -- inputs --------------------------------------------------------------
    def heartbeat(self, host: int, step_time: float) -> None:
        """Record one liveness report; beats from evicted hosts are
        ignored (re-admission is explicit via :meth:`rejoin`)."""
        if host not in self._alive:
            return
        if self._chaos is not None and self._chaos.should_kill_host(host):
            # injected host death: swallow the beat so the timeout
            # detector sees this host go silent
            return
        self._last_seen[host] = self._clock()
        self._step_time[host] = float(step_time)

    def rejoin(self, host: int) -> None:
        """Re-admit a host; forces a reshape to fold it into the mesh."""
        self._alive.add(host)
        self._last_seen[host] = self._clock()
        self._slow_ticks.pop(host, None)
        self._step_time.pop(host, None)
        self.events.append(f"rejoin host {host}")
        if self.phase != RunPhase.HALTED:
            self.phase = RunPhase.RESHAPING

    # -- evaluation ----------------------------------------------------------
    def tick(self) -> RunPhase:
        """Evaluate liveness now; returns the (possibly new) phase."""
        if self.phase == RunPhase.HALTED:
            return self.phase
        now = self._clock()
        cfg = self.config
        evicted = False

        for h in sorted(self._alive):
            if now - self._last_seen[h] > cfg.heartbeat_timeout:
                self._evict(h, f"failed host {h}: no heartbeat for "
                               f"{now - self._last_seen[h]:.1f}s")
                evicted = True

        if cfg.straggler_factor > 0 and len(self._alive) >= 2:
            times = sorted(self._step_time[h] for h in self._alive
                           if h in self._step_time)
            if times:
                median = times[len(times) // 2]
                for h in sorted(self._alive):
                    t = self._step_time.get(h)
                    if t is not None and t > cfg.straggler_factor * median:
                        n = self._slow_ticks.get(h, 0) + 1
                        self._slow_ticks[h] = n
                        if n >= cfg.straggler_patience:
                            self._evict(
                                h, f"straggler host {h}: {t:.2f}s vs "
                                   f"median {median:.2f}s for {n} ticks")
                            evicted = True
                    else:
                        self._slow_ticks.pop(h, None)

        if len(self._alive) < cfg.min_hosts:
            self.phase = RunPhase.HALTED
            self.events.append(
                f"halt: {len(self._alive)} hosts < min_hosts "
                f"{cfg.min_hosts}")
        elif evicted:
            self.phase = RunPhase.RESHAPING
        return self.phase

    def _evict(self, host: int, event: str) -> None:
        self._alive.discard(host)
        self._slow_ticks.pop(host, None)
        self._step_time.pop(host, None)
        self.events.append(event)

    def complete_reshape(self) -> None:
        """The runner rebuilt its mesh; resume stepping."""
        if self.phase == RunPhase.RESHAPING:
            self.phase = RunPhase.RUNNING

    # -- introspection -------------------------------------------------------
    def alive_hosts(self) -> Set[int]:
        return set(self._alive)


def plan_mesh(n_devices: int, model_parallel: int,
              multi_pod_size: Optional[int] = None
              ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The largest valid mesh for ``n_devices`` surviving devices.

    Model parallelism stays fixed (weights are laid out over it); the
    data axis absorbs the loss, so after one 16-device host of a
    256-device pod dies, ``plan_mesh(240, 16) == ((15, 16), ...)``.
    With ``multi_pod_size`` set and more than one pod's worth of devices,
    a leading "pod" axis is planned (pods must be whole).

    Raises ``ValueError`` when the survivors cannot form a rectangular
    mesh at the requested model parallelism.
    """
    if n_devices <= 0 or model_parallel <= 0:
        raise ValueError(f"need positive device counts, got "
                         f"{n_devices=} {model_parallel=}")
    if multi_pod_size is not None and n_devices > multi_pod_size:
        if (n_devices % multi_pod_size != 0
                or multi_pod_size % model_parallel != 0):
            raise ValueError(
                f"{n_devices} devices do not form whole pods of "
                f"{multi_pod_size} at model={model_parallel}")
        pods = n_devices // multi_pod_size
        data = multi_pod_size // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by model parallelism "
            f"{model_parallel}; evict down to a multiple or replan")
    return ((n_devices // model_parallel, model_parallel),
            ("data", "model"))


class TrainingSupervisor:
    """Drives a step loop under a controller: save on a cadence, restore
    + restart when the controller demands a reshape.

    ``run`` is runner-agnostic: the callables own the actual mesh and
    state.  ``step_fn(step)`` executes one (0-based) step and returns its
    duration; ``save_fn(completed)`` / ``restore_fn() -> completed``
    round-trip checkpoints labeled by the number of completed steps —
    ``restore_fn``'s return value is therefore the next step index to
    run, so a restored step is never re-executed;
    ``reporting_fn(step) -> hosts`` stands in for the heartbeat transport
    (defaults to "every alive host reports").
    """

    def __init__(self, controller: FaultTolerantController,
                 save_every: int = 100):
        self.controller = controller
        self.save_every = save_every

    def run(self, total_steps: int,
            step_fn: Callable[[int], float],
            save_fn: Callable[[int], None],
            restore_fn: Callable[[], int],
            reporting_fn: Optional[Callable[[int], Sequence[int]]] = None,
            start_step: int = 0) -> int:
        """Run steps ``start_step..total_steps`` to completion; returns
        the number of checkpoint restarts needed along the way.
        ``start_step`` lets a driver resume a checkpointed run under the
        same supervisor (the restore path already reports the restored
        step; this is the cold-resume equivalent)."""
        ctl = self.controller
        restarts = 0
        step = start_step
        last_dur = 0.0
        while step < total_steps:
            hosts = (reporting_fn(step) if reporting_fn is not None
                     else sorted(ctl.alive_hosts()))
            last_dur = step_fn(step)
            for h in hosts:
                ctl.heartbeat(h, last_dur)
            phase = ctl.tick()
            if phase == RunPhase.HALTED:
                break
            if phase == RunPhase.RESHAPING:
                ctl.complete_reshape()
                restarts += 1
                step = restore_fn()
                continue
            if self.save_every and (step + 1) % self.save_every == 0:
                save_fn(step + 1)  # checkpoints are labeled by steps COMPLETED
            step += 1
        return restarts
