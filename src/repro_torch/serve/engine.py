"""Batched serving engine: prefill + decode with KV and recurrent caches.

Fixed-batch slots, greedy or temperature sampling, per-slot stop handling,
and one decode step for the whole batch.  ``launch/serve.py`` drives it.

Incremental logit views (LINVIEW's serving integration) attach here:
hot-swap deltas to a head are queued on its view and coalesced, so a burst
of T adapter updates costs one batched trigger firing per view, and
:meth:`ServeEngine.replan_views` hot-swaps a maintenance plan into every
view.  With ``degrade`` (a :class:`repro_torch.guard.DegradePolicy`) every
attached view is wrapped in a :class:`~repro_torch.guard.GuardedView`:
retried, breaker-gated refreshes and a last-good snapshot served while
the breaker is open.  :meth:`ServeEngine.attach_fleet` backs views by a
multi-tenant :class:`repro_torch.fleet.FleetScheduler` instead: hot-swap
deltas enter a tenant's update log through admission control, and reads
serve the tenant's committed snapshot.  :meth:`ServeEngine.save_checkpoint`
and :meth:`ServeEngine.restore_checkpoint` persist the weights through a
:class:`repro_torch.dist.checkpoint.CheckpointManager`.

Made under ``use_sharding(mesh, rules)`` with the rank's local params,
the engine serves on that mesh (it keeps the placement and installs it
around each call): the cache is the rank's block of
``LM.cache_specs(batch_size, max_seq)`` (under the ``"cache_seq"`` rule,
its block of the slots), each rank runs its rows of the global prompts,
and the logits are gathered whole, so every rank samples the same
tokens.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..dist import sharding
from ..models.model import LM, RECURRENT
from .incremental_views import IncrementalLogitView


@dataclass
class ServeEngine:
    model: LM
    params: Any
    batch_size: int = 8
    max_seq: int = 2048
    temperature: float = 0.0
    seed: int = 0
    #: optional :class:`repro_torch.guard.DegradePolicy` — wraps every
    #: attached logit view in retry + circuit-breaker + last-good-snapshot
    #: serving
    degrade: Optional[Any] = None
    _logit_views: Dict[str, IncrementalLogitView] = field(
        default_factory=dict, init=False)
    _view_guards: Dict[str, Any] = field(default_factory=dict, init=False)
    _fleet: Optional[Any] = field(default=None, init=False)
    _fleet_tenants: Dict[str, str] = field(default_factory=dict, init=False)

    def __post_init__(self):
        if self.model.cfg.encoder_only:
            raise ValueError("encoder-only model has no decode step")
        ctx = sharding.current_ctx()
        self._ctx = ctx if ctx.mesh is not None else None
        self._specs = None
        if self._ctx is not None:
            self._specs = self.model.cache_specs(self.batch_size,
                                                 self.max_seq)
            self._row_spec = sharding.resolve_spec(("batch",),
                                                   (self.batch_size,))
        self.cache = self._new_cache()
        self._gen = torch.Generator(device=self.model.device)
        self._gen.manual_seed(self.seed)
        self._pos = 0

    def _new_cache(self):
        return self.model.init_cache(self.batch_size, self.max_seq,
                                     self._specs)

    def _placed(self):
        """The engine's placement, installed for the duration (nothing
        without a mesh)."""
        if self._ctx is None:
            return contextlib.nullcontext()
        return sharding.installed(self._ctx)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (B, ...) batch on a mesh."""
        if self._ctx is None:
            return x
        return sharding.local_block(x, self._row_spec, self._ctx)

    def _whole(self, logits: torch.Tensor) -> torch.Tensor:
        """A mesh rank's (rows, ..., vocab shard) logits gathered whole."""
        if self._ctx is None:
            return logits
        if logits.shape[-1] != self.model.cfg.vocab:
            logits = sharding.gather(logits, -1, sharding.MODEL, self._ctx)
        return sharding.gather(logits, 0,
                               sharding.spec_axes(self._row_spec), self._ctx)

    def prefill(self, prompts) -> torch.Tensor:
        """Fill the cache from the prompts.

        The transformer families take one batched pass; the recurrent
        families (hybrid, ssm) step their states through ``decode_step``
        token by token at positions 0..S-1, from a zeroed cache (the
        reference steps from whatever the engine's cache holds, so its
        second prefill continues the first's state).

        prompts: (B, S) ints → last-token logits (B, V).  Tokens only, as
        the reference's: a vlm's image prefix goes through ``LM.prefill``.
        """
        b, s = prompts.shape
        if b != self.batch_size:
            raise ValueError(f"{b} prompts for {self.batch_size} slots")
        tokens = self._rows(torch.as_tensor(prompts, device=self.model.device))
        with self._placed():
            if self.model.cfg.family not in RECURRENT:
                logits, self.cache = self.model.prefill(
                    self.params, {"tokens": tokens}, max_seq=self.max_seq,
                    specs=self._specs)
                self._pos = s
                return self._whole(logits[:, -1, :])
            _zero_(self.cache)
            for t in range(s):
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache, tokens[:, t:t + 1], t,
                    self._specs)
            self._pos = s
            return self._whole(logits[:, 0, :])

    def decode(self, tokens) -> torch.Tensor:
        """One decode step for the whole batch at the current position:
        tokens (B,) → logits (B, V)."""
        tokens = self._rows(torch.as_tensor(tokens, device=self.model.device
                                            ).reshape(-1, 1))
        with self._placed():
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, tokens, self._pos, self._specs)
            self._pos += 1
            return self._whole(logits[:, 0, :])

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits → (B,) int32 tokens: argmax, or a draw from
        softmax(logits / temperature) with the engine's seeded generator."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    def generate(self, prompts, max_new: int = 32,
                 stop_token: Optional[int] = None) -> np.ndarray:
        """Prefill, then ``max_new`` tokens per slot: (B, max_new) int32
        (fewer columns if every slot hit ``stop_token``)."""
        tok = self.sample(self.prefill(prompts))
        out: List[np.ndarray] = []
        done = np.zeros(self.batch_size, bool)
        for _ in range(max_new):
            host = tok.cpu().numpy()
            out.append(host)
            if stop_token is not None:
                done |= host == stop_token
                if done.all():
                    break
            tok = self.sample(self.decode(tok))
        return np.stack(out, axis=1)

    # -- incremental logit views ------------------------------------------------
    def attach_logit_view(self, weight_path: str,
                          view: IncrementalLogitView) -> None:
        """Register a view maintained for the weight at ``weight_path``
        (e.g. ``"lm_head"``)."""
        if not IncrementalLogitView.covers(weight_path):
            raise ValueError(
                f"{weight_path!r} is behind a nonlinearity; its cached "
                f"views cannot be maintained exactly — re-encode instead")
        self._logit_views[weight_path] = view
        if self.degrade is not None:
            from ..guard import GuardedView
            self._view_guards[weight_path] = GuardedView(view, self.degrade)

    def attach_fleet(self, fleet, tenant_of: Dict[str, str]) -> None:
        """Back logit views by a shared multi-tenant fleet service.

        ``fleet`` is a :class:`repro_torch.fleet.FleetScheduler`;
        ``tenant_of`` maps weight paths to tenant ids already registered
        in it (over :func:`~repro_torch.serve.incremental_views.
        build_logit_view_program` programs).  Hot-swap deltas for these
        paths go through the fleet's admission control into the tenant's
        update log (so they survive worker crashes), reads come from the
        tenant's committed snapshot, and :meth:`view_health` reports the
        tenant's lease/breaker/staleness state.  Paths may be fleet- or
        locally-backed side by side; fleet routing wins where both
        exist."""
        for path, tenant_id in tenant_of.items():
            if not IncrementalLogitView.covers(path):
                raise ValueError(
                    f"{path!r} is behind a nonlinearity; its cached "
                    f"views cannot be maintained exactly")
            fleet.registry.get(tenant_id)   # raises on unknown tenant
        self._fleet = fleet
        self._fleet_tenants.update(tenant_of)

    def _fleet_paths(self):
        """The weight paths backed by the attached fleet (none before
        :meth:`attach_fleet`)."""
        return self._fleet_tenants if self._fleet is not None else {}

    def _fleet_tenant(self, weight_path: str) -> Optional[str]:
        """The fleet tenant backing ``weight_path``, or None."""
        return self._fleet_paths().get(weight_path)

    def hot_swap(self, weight_path: str, u, v) -> bool:
        """Route a low-rank weight delta ``W += u vᵀ`` to the cached corpus
        view of ``weight_path``.  Swapping the delta into ``self.params``
        is the caller's job.  Returns True if this enqueue flushed the
        view (its logits are fresh now); for a fleet-backed path, True if
        the fleet admitted the delta (its refresh is asynchronous, bounded
        by the tenant's SLO), False on throttling or shedding.  The
        factors go to the fleet as they are: card tensors stay on the
        card."""
        tenant_id = self._fleet_tenant(weight_path)
        if tenant_id is not None:
            return self._fleet.submit(tenant_id, "W", u, v) == "admitted"
        if weight_path not in self._logit_views:
            raise KeyError(f"no logit view attached for {weight_path!r}; "
                           f"have {sorted(self._logit_views)} and fleet "
                           f"paths {sorted(self._fleet_paths())}")
        guard = self._view_guards.get(weight_path)
        if guard is not None:
            # retried + breaker-gated: a repeatedly failing refresh trips
            # the breaker and the view degrades to its last-good snapshot
            return guard.submit(u, v)
        return self._logit_views[weight_path].submit_head_update(u, v)

    def flush_views(self) -> None:
        """Force all pending hot-swap deltas into the maintained views.
        Guarded views retry with backoff; a view whose breaker is open
        stays on its snapshot (see :meth:`view_health`) instead of
        raising.  Fleet-backed paths drain their tenants (inline, or by
        waiting on the fleet's live workers)."""
        for path, view in self._logit_views.items():
            guard = self._view_guards.get(path)
            if guard is not None:
                guard.flush()
            else:
                view.flush()
        if self._fleet_paths():
            self._fleet.drain(self._fleet_tenants.values())

    def view_logits(self, weight_path: str) -> torch.Tensor:
        """One view's logits at bounded staleness: fresh when healthy,
        the last-good snapshot when degraded (unguarded views read
        straight through); a fleet-backed path reads its tenant's
        committed snapshot."""
        tenant_id = self._fleet_tenant(weight_path)
        if tenant_id is not None:
            return self._fleet.read(tenant_id, "Y")
        guard = self._view_guards.get(weight_path)
        if guard is not None:
            return guard.read()
        return self._logit_views[weight_path].logits

    def replan_views(self, workload) -> Dict[str, Any]:
        """Hot-swap a cost-based maintenance re-plan into every attached
        logit view (e.g. when the adapter-delta traffic profile shifts).

        ``workload`` is a :class:`repro_torch.plan.WorkloadDescriptor`;
        each view prices its own plan against it.  Pending queued deltas
        survive the swap and flush on the unchanged thresholds under the
        new plan.  Returns {weight_path: installed plan}.
        """
        return {path: view.replan(workload)
                for path, view in self._logit_views.items()}

    # -- checkpoint hooks ----------------------------------------------------
    def save_checkpoint(self, manager, step: int,
                        blocking: bool = False) -> str:
        """Snapshot the serving weights through a
        :class:`repro_torch.dist.checkpoint.CheckpointManager`.

        Only ``params`` are persisted: decode caches are per-request
        transients, and incremental logit views rebuild from the weights
        they were attached with.  A stream of low-rank hot-swap deltas
        between saves is exactly the workload the manager's factored
        incremental checkpoints compress well.
        """
        return manager.save(step, self.params, blocking=blocking)

    def restore_checkpoint(self, manager, step: Optional[int] = None
                           ) -> "ServeEngine":
        """Load weights from checkpoint ``step`` (default latest) onto the
        params' devices and reset all weight-derived serving state: the
        decode cache (KV computed under the old weights must not leak
        into post-restore requests) and any attached logit views (they
        may have absorbed hot-swap deltas newer than the checkpoint and
        cannot be rolled back — re-attach them against the restored
        weights; a stale ``hot_swap`` call now raises instead of silently
        diverging)."""
        self.params = manager.restore(self.params, step=step)
        self.cache = self._new_cache()
        self._pos = 0
        self._logit_views.clear()
        self._view_guards.clear()
        return self

    def view_health(self) -> Dict[str, Dict[str, Any]]:
        """Per-view serving health: breaker state, staleness bound,
        retry/degradation counters (``{"serving": "fresh"}`` for
        unguarded views)."""
        out: Dict[str, Dict[str, Any]] = {}
        for path in self._logit_views:
            guard = self._view_guards.get(path)
            out[path] = (guard.health() if guard is not None
                         else {"breaker": None, "serving": "fresh",
                               "staleness_s": 0.0})
        for path in self._fleet_paths():
            out[path] = self._fleet.registry.get(
                self._fleet_tenants[path]).health()
        return out


def _zero_(tree) -> None:
    """Zero every tensor of a cache tree in place."""
    for leaf in tree.values():
        if isinstance(leaf, dict):
            _zero_(leaf)
        else:
            leaf.zero_()


def make_serve_step(model: LM, cache_specs=None):
    """The decode entry point: one token for the whole batch
    (``cache_specs``: the cache's placement, :meth:`LM.decode_step`)."""

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos, cache_specs)

    return serve_step


def make_prefill_step(model: LM):
    """The prefill entry point: full forward, returns logits."""

    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step
