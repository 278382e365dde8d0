"""Checkpointing: full snapshots + LINVIEW factored incremental deltas.

The port of the JAX package's ``dist/checkpoint.py``, with its on-disk
format unchanged: a checkpoint written by either package restores in the
other.

The LINVIEW idea applied to training state: between two nearby steps most
large matrices change by a numerically low-rank delta (an optimizer step
driven by low-rank gradients, an adapter hot-swap, a single retrained
head row).  So instead of writing the full tree every time, the manager
writes

  * a **full** checkpoint every ``full_every`` steps (the *base*), and
  * **incremental** checkpoints in between: per matrix leaf the delta
    against the previous checkpoint is SVD-sketched to ``P Qᵀ`` with
    rank ≤ ``incremental_rank``; if the truncation error exceeds
    ``max_rel_err`` (the delta is genuinely high-rank) that leaf falls
    back to a raw copy — the §5.3 hybrid choice, per leaf, on disk.

On-disk format (see docs/dist.md):

  ``ckpt_<step>.json``   manifest: kind (full|incremental), base_step,
                         per-leaf entry {kind: full|lr|raw|same, shape,
                         dtype}
  ``ckpt_<step>.npz``    payload arrays keyed ``full::<leaf>``,
                         ``lr_p::<leaf>`` + ``lr_q::<leaf>``,
                         ``raw::<leaf>``

A leaf is keyed by its address in the tree, spelled as the reference's
``jax.tree_util.keystr`` spells it: a dict key as ``['k']`` (keys in
sorted order), a NamedTuple field as ``.field``, a sequence item as
``[i]``; ``None`` is no leaf.  So a ``TrainState`` reads
``.params['blocks']['w']``, ``.opt.step``, ``.rng``.  Tensors keep the
reference's dtype names in the manifest (``"bfloat16"``, not
``"torch.bfloat16"``); a bf16 leaf is stored as f32, as the reference
stores it.  A ``torch.Generator`` leaf is stored as its state, a
``uint8`` array, and restored as a generator on the template's device.

Restore walks the chain: latest full base, then every incremental up to
the requested step, applying ``leaf += P Qᵀ`` / replacements in order.
Deltas are always computed against the *reconstructed* previous
checkpoint (not the in-memory exact tree), so sketch truncation never
compounds across a chain.  Encoding, the sketch and reconstruction are
numpy on the host, as in the reference, so for the same numpy tree the
two packages write the same arrays and checksums.

Garbage collection keeps the last ``keep`` checkpoints *plus any base a
kept incremental (transitively) depends on* — an incremental whose base
was collected would be unrestorable.

Every payload array is written with a CRC32 content checksum in the
manifest; :meth:`CheckpointManager.restore` verifies them and, when a
checkpoint (or its chain) is corrupt, falls back to the newest earlier
step that reconstructs intact (``last_restored_step`` records which one
actually loaded — callers resuming training should trust it over
``latest_step``).
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import sharding

FORMAT_VERSION = 1
_PREFIX = "ckpt_"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's payload failed checksum verification (or could not
    be decoded at all)."""


def _crc(x: np.ndarray) -> int:
    # the CRC32 of the array's C-order bytes (the reference's
    # ``tobytes()``), read in place
    return zlib.crc32(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_tree(fn: Callable[[str, Any], Any], tree: Any, path: str = "",
              is_leaf: Callable[[Any], bool] = lambda x: False):
    """``tree`` rebuilt with every leaf replaced by ``fn(path, leaf)``,
    walking it as :func:`_leaf_paths` does; None stays None; a node that
    ``is_leaf`` accepts is a leaf."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], f"{path}[{k!r}]", is_leaf)
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_tree(fn, getattr(tree, f), f"{path}.{f}",
                                      is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x, f"{path}[{i}]", is_leaf)
                          for i, x in enumerate(tree))
    return fn(path, tree)


def _spec_paths(specs: Any) -> Dict[str, Any]:
    """{leaf path: PartitionSpec} of a placement tree that mirrors a
    checkpointed tree (:func:`repro_torch.train.train_state_specs`)."""
    out: Dict[str, Any] = {}
    _map_tree(lambda p, s: out.__setitem__(p, s), specs,
              is_leaf=sharding.is_axes_leaf)
    return out


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """Stable (path-string, leaf) pairs; path is the tree address, as
    ``jax.tree_util.keystr`` writes it, in its flattening order."""
    out: List[Tuple[str, Any]] = []
    _map_tree(lambda p, x: out.append((p, x)), tree)
    return out


def _dtype_name(leaf: Any) -> str:
    """The leaf's dtype as the reference's manifest names it."""
    if isinstance(leaf, torch.Generator):
        return "uint8"
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(leaf.dtype if hasattr(leaf, "dtype")
               else np.asarray(leaf).dtype)


def _stage(leaf: Any) -> Any:
    """Caller-thread snapshot: an *owned* buffer the training loop can
    no longer touch, at device-copy (not device-to-host) cost.

    A tensor is cloned on its own device (the port's train step updates
    params and optimizer state in place, so an alias would let the next
    step write into a checkpoint that ``save`` already returned from);
    the expensive device-to-host gather of the copy happens later, on
    the writer thread.  A generator's state comes back as a new uint8
    tensor.  Host leaves are np.array-copied (asarray would alias: the
    loop could mutate a checkpoint that save() already returned from,
    and the incremental "same"-detection would compare a buffer against
    itself).
    """
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return np.array(leaf)


def _to_host(leaf: Any) -> np.ndarray:
    # writer-thread side of the snapshot: gather the staged (owned)
    # buffer to host numpy; this is the blocking device-to-host copy.
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.cpu()
        if leaf.dtype == torch.bfloat16:
            # no numpy bfloat16: stage as float32; the manifest remembers
            # the real dtype and restore casts back (exactly)
            leaf = leaf.float()
        return leaf.numpy()
    x = np.asarray(leaf)
    if x.dtype.kind not in "fiub" or x.dtype.itemsize == 0:
        x = x.astype(np.float32)
    return x


def _storage_dtype(x: np.ndarray) -> np.ndarray:
    return x if x.dtype.kind in "fiub" else x.astype(np.float32)


def _restore_leaf(template: Any, val: np.ndarray, spec=None) -> Any:
    """``val`` shaped like ``template``: a tensor on its device with its
    dtype and ``requires_grad``; a generator on its device with the
    saved state; else a numpy array of its dtype and shape.  With a
    ``spec``, ``val`` is the whole leaf and ``template`` this rank's block
    of it on the active mesh, which is what comes back."""
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.from_numpy(
            np.array(val, dtype=np.uint8).reshape(-1)))
        return gen
    if isinstance(template, torch.Tensor):
        host = torch.from_numpy(np.require(val, requirements=["C", "W"]))
        if spec is not None:
            host = sharding.local_block(host, spec)
            if host.shape != template.shape:
                raise ValueError(f"a block of {tuple(val.shape)} is "
                                 f"{tuple(host.shape)} on this rank, the "
                                 f"template's {tuple(template.shape)}")
        out = host.to(dtype=template.dtype).reshape(template.shape).to(
            template.device)
        return out.requires_grad_(template.requires_grad)
    tarr = np.asarray(template)
    return np.asarray(val).astype(tarr.dtype).reshape(tarr.shape)


class CheckpointManager:
    """Save/restore trees of tensors (dicts, NamedTuples, tuples, lists;
    tensor, generator and numpy leaves) with optional factored
    incremental deltas.

    Parameters
    ----------
    directory:          where ``ckpt_*.json`` / ``ckpt_*.npz`` live.
    async_save:         gather + encode + write on a background thread;
                        ``save`` returns after staging owned copies on
                        each leaf's device (the state can keep training,
                        in place, immediately).  ``blocking=True`` per
                        call (or :meth:`wait`) forces completion.
    keep:               GC budget — newest ``keep`` checkpoints survive,
                        plus the bases their chains need.
    incremental_rank:   rank cap for factored deltas; ``None`` disables
                        incremental checkpoints entirely (always full).
    full_every:         steps between full bases; an incremental is
                        written only while ``step - last_full < full_every``.
    max_rel_err:        Frobenius-relative truncation error above which a
                        leaf's delta abandons the sketch and stores raw.
    min_dim:            matrix leaves smaller than this on either side
                        are never sketched (factors would not pay).
    chaos:              optional :class:`repro_torch.guard.ChaosConfig` /
                        ``ChaosMonkey`` — corrupts written payloads with
                        probability ``corrupt_checkpoint_p`` (testing the
                        checksum/fallback path).

    ``last_save_s`` holds the seconds the most recent save spent in each
    part: ``stage`` (on the caller's thread), then, on the writer,
    ``gather`` (device to host), ``encode`` (full or incremental, and the
    checksums) and ``write`` (payload, manifest, GC).
    """

    def __init__(self, directory: str, *, async_save: bool = True,
                 keep: int = 5, incremental_rank: Optional[int] = None,
                 full_every: int = 10, max_rel_err: float = 1e-3,
                 min_dim: int = 8, chaos: Any = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.keep = keep
        self.incremental_rank = incremental_rank
        self.full_every = full_every
        self.max_rel_err = max_rel_err
        self.min_dim = min_dim
        self._chaos = None
        if chaos is not None:
            from ..guard.chaos import as_monkey
            self._chaos = as_monkey(chaos)
        #: the step the most recent :meth:`restore` actually loaded —
        #: may be earlier than requested after a corruption fallback
        self.last_restored_step: Optional[int] = None
        self.last_save_s: Dict[str, float] = {}
        self._executor = (ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="ckpt")
                          if async_save else None)
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()
        # reconstructed value of the last checkpoint on disk (path → np);
        # incremental deltas diff against THIS, so sketch truncation does
        # not compound along a chain.
        self._base: Optional[Dict[str, np.ndarray]] = None
        self._base_step: Optional[int] = None
        self._last_full: Optional[int] = None

    # -- paths / listing -----------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}")

    def all_steps(self) -> List[int]:
        """Steps with a complete (manifest present) checkpoint, sorted."""
        self.wait()
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name.endswith(".json"):
                try:
                    steps.append(int(name[len(_PREFIX):-len(".json")]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self, specs: Any = None) -> Optional[int]:
        """The newest complete step, or None.  With ``specs`` (a sharded
        state's placement, as :meth:`restore` takes it) every rank of the
        mesh calls it: it first waits for rank 0's writes, in flight or
        not, so that every rank lists the same steps."""
        if specs is not None:
            self.wait()
            sharding.mesh_barrier()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until any in-flight async save has hit the disk."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def close(self) -> None:
        """Finish any in-flight save and stop the writer thread."""
        self.wait()
        if self._executor is not None:
            self._executor.shutdown()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             specs: Any = None) -> str:
        """Write ``tree`` as checkpoint ``step``; returns the path prefix
        (manifest at ``<path>.json``, payload at ``<path>.npz``).

        With ``specs`` (the tree's placement on the active mesh, e.g.
        :func:`repro_torch.train.train_state_specs`) ``tree`` holds local
        blocks: the ranks gather whole leaves (a collective: every rank of
        the mesh calls ``save``; the ranks off the first coordinate of the
        axes nothing is split over skip it, holding copies) and rank 0
        writes the reference's format, which either package restores on
        one device.  The other ranks write nothing.

        The caller thread only *stages* the snapshot: one owned copy per
        leaf, on the leaf's own device (enqueued on the current stream,
        for card tensors).  The device-to-host gather, the
        full/incremental encoding and the disk write all happen on the
        writer thread when ``async_save``; the gather first waits for the
        copies.  The training loop may update its tensors in place the
        moment this returns.  ``save`` waits for any previous in-flight
        save first, so the writer-side encoder state
        (``_base``/``_last_full``) is single-threaded.
        """
        self.wait()
        if specs is not None:
            tree = self._gathered(tree, specs)
            if tree is None:
                return self._path(step)
        t0 = time.perf_counter()
        staged: Dict[str, Any] = {}
        dtypes: Dict[str, str] = {}
        for p, x in _leaf_paths(tree):
            dtypes[p] = _dtype_name(x)
            staged[p] = _stage(x)
        # the copies run on each card's current stream; the writer's
        # gather runs on its own thread's stream, so it waits for these
        ready = [torch.cuda.current_stream(dev).record_event()
                 for dev in {x.device for x in staged.values()
                             if isinstance(x, torch.Tensor) and x.is_cuda}]
        timings = {"stage": time.perf_counter() - t0}
        path = self._path(step)

        def gather_encode_write():
            t0 = time.perf_counter()
            for event in ready:
                event.synchronize()
            host = {p: _to_host(x) for p, x in staged.items()}
            staged.clear()   # free the device copies as soon as gathered
            t1 = time.perf_counter()
            incremental = (
                self.incremental_rank is not None
                and self._base is not None
                and self._base_step is not None
                and self._last_full is not None
                and step - self._last_full < self.full_every
                and set(self._base) == set(host)
            )
            if incremental:
                payload, manifest, recon = self._encode_incremental(
                    step, host, dtypes)
            else:
                payload = {f"full::{p}": _storage_dtype(x)
                           for p, x in host.items()}
                manifest = {"format_version": FORMAT_VERSION, "kind": "full",
                            "step": step, "base_step": None,
                            "leaves": {p: {"kind": "full",
                                           "shape": list(host[p].shape),
                                           "dtype": dtypes[p]}
                                       for p in host}}
                recon = host
                self._last_full = step
            manifest["checksums"] = {k: _crc(v) for k, v in payload.items()}
            self._base = recon
            self._base_step = step
            t2 = time.perf_counter()
            with self._lock:
                np.savez(path + ".npz", **payload)
                if self._chaos is not None:
                    self._chaos.maybe_corrupt_checkpoint(path + ".npz")
                with open(path + ".json", "w") as f:
                    json.dump(manifest, f, indent=1)
                self._gc()
            self.last_save_s = {**timings, "gather": t1 - t0,
                                "encode": t2 - t1,
                                "write": time.perf_counter() - t2}

        if self._executor is not None and not blocking:
            self._inflight = self._executor.submit(gather_encode_write)
        else:
            gather_encode_write()
        return path

    def _gathered(self, tree: Any, specs: Any) -> Any:
        """Whole leaves on rank 0 (and on the ranks that gather beside
        it); None on the ranks that write nothing."""
        ctx = sharding.current_ctx()
        split = set()
        sharding.map_axes(lambda s: split.update(sharding.spec_axes(s)),
                          specs)
        copies = [a for a in ctx.mesh.mesh_dim_names if a not in split]
        if ctx.coord(copies):
            return None
        whole = sharding.gather_tree(tree, specs, ctx)
        return whole if ctx.coord(ctx.mesh.mesh_dim_names) == 0 else None

    def _encode_incremental(self, step: int, host: Dict[str, np.ndarray],
                            dtypes: Dict[str, str]):
        payload: Dict[str, np.ndarray] = {}
        leaves: Dict[str, Dict] = {}
        recon: Dict[str, np.ndarray] = {}
        rank = int(self.incremental_rank)
        for p, new in host.items():
            base = self._base[p]
            entry = {"shape": list(new.shape), "dtype": dtypes[p]}
            if new.shape == base.shape and np.array_equal(new, base):
                entry["kind"] = "same"
                recon[p] = base
            elif (new.ndim == 2 and new.shape == base.shape
                    and min(new.shape) >= max(self.min_dim, rank + 1)):
                delta = (new.astype(np.float32)
                         - base.astype(np.float32))
                P, Q, rel = _sketch_delta(delta, rank)
                if rel <= self.max_rel_err:
                    entry["kind"] = "lr"
                    payload[f"lr_p::{p}"] = P
                    payload[f"lr_q::{p}"] = Q
                    recon[p] = (base.astype(np.float32)
                                + P @ Q.T).astype(base.dtype)
                else:
                    entry["kind"] = "raw"
                    payload[f"raw::{p}"] = _storage_dtype(new)
                    recon[p] = new
            else:
                entry["kind"] = "raw"
                payload[f"raw::{p}"] = _storage_dtype(new)
                recon[p] = new
            leaves[p] = entry
        manifest = {"format_version": FORMAT_VERSION, "kind": "incremental",
                    "step": step, "base_step": self._base_step,
                    "leaves": leaves}
        return payload, manifest, recon

    # -- restore ------------------------------------------------------------
    def _manifest(self, step: int) -> Dict:
        with open(self._path(step) + ".json") as f:
            return json.load(f)

    def _chain(self, step: int) -> List[Dict]:
        """Manifests from the full base (first) up to ``step`` (last)."""
        chain = []
        s: Optional[int] = step
        while True:
            if s is None:
                raise FileNotFoundError(
                    f"broken incremental chain below step {step} in "
                    f"{self.directory}")
            man = self._manifest(s)
            chain.append(man)
            if man["kind"] == "full":
                return list(reversed(chain))
            s = man["base_step"]

    def _load_payload(self, man: Dict) -> Dict[str, np.ndarray]:
        """Load one checkpoint's payload, verifying content checksums
        (when the manifest has them — older checkpoints are trusted)."""
        path = self._path(man["step"]) + ".npz"
        checksums = man.get("checksums")
        data: Dict[str, np.ndarray] = {}
        try:
            with np.load(path) as npz:
                for k in npz.files:
                    data[k] = npz[k]
        except Exception as e:  # zip/zlib/ValueError: undecodable payload
            raise CheckpointCorruptError(
                f"checkpoint {man['step']}: unreadable payload "
                f"{path!r}: {e!r}") from e
        if checksums is not None:
            if set(checksums) != set(data):
                raise CheckpointCorruptError(
                    f"checkpoint {man['step']}: payload keys do not match "
                    f"manifest checksums")
            for k, want in checksums.items():
                if _crc(data[k]) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint {man['step']}: checksum mismatch on "
                        f"{k!r}")
        return data

    def _reconstruct(self, step: int) -> Dict[str, np.ndarray]:
        leaves: Dict[str, np.ndarray] = {}
        for man in self._chain(step):
            data = self._load_payload(man)
            if man["kind"] == "full":
                leaves = {p: data[f"full::{p}"] for p in man["leaves"]}
                continue
            for p, info in man["leaves"].items():
                if info["kind"] == "same":
                    continue
                if info["kind"] == "raw":
                    leaves[p] = data[f"raw::{p}"]
                else:  # lr: leaf += P Qᵀ
                    base = leaves[p].astype(np.float32)
                    leaves[p] = base + data[f"lr_p::{p}"] @ data[f"lr_q::{p}"].T
        return leaves

    def restore(self, template: Any, step: Optional[int] = None,
                specs: Any = None) -> Any:
        """Rebuild checkpoint ``step`` (default: latest) shaped like
        ``template``: the same tree; each leaf is cast to the template
        leaf's dtype and placed on its device, a tensor with the
        template's ``requires_grad`` (restored params take the next train
        step as they are), a generator with the saved state.

        Payload checksums are verified along the whole chain.  When the
        requested checkpoint is corrupt (or its chain is broken), restore
        falls back to the newest *earlier* step that reconstructs intact
        — ``last_restored_step`` records the step actually loaded, so
        resuming callers can replay from the right place.

        With ``specs`` (the template's placement on the active mesh) the
        template holds local blocks: every rank of the mesh calls
        ``restore`` (it first waits for rank 0's writes), reads whole
        leaves and keeps its blocks of them for the *current* mesh, so a
        checkpoint written on one mesh restores onto another (an elastic
        re-mesh) or onto one device."""
        self.wait()
        spec_at = None
        if specs is not None:
            sharding.mesh_barrier()
            spec_at = _spec_paths(specs)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        leaves = None
        errors: List[str] = []
        for s in [c for c in reversed(self.all_steps()) if c <= step]:
            try:
                leaves = self._reconstruct(s)
            except (CheckpointCorruptError, FileNotFoundError) as e:
                errors.append(str(e))
                continue
            self.last_restored_step = s
            break
        if leaves is None:
            raise CheckpointCorruptError(
                f"no intact checkpoint at or below step {step} in "
                f"{self.directory}: " + "; ".join(errors))

        def load(p: str, tleaf: Any) -> Any:
            if p not in leaves:
                raise KeyError(f"checkpoint {step} has no leaf {p!r}")
            return _restore_leaf(tleaf, leaves[p],
                                 spec_at[p] if spec_at else None)

        return _map_tree(load, template)

    # -- GC -----------------------------------------------------------------
    def _gc(self) -> None:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name.endswith(".json"):
                try:
                    steps.append(int(name[len(_PREFIX):-len(".json")]))
                except ValueError:
                    continue
        steps.sort()
        retained = set(steps[-self.keep:]) if self.keep else set(steps)
        # keep every base a retained incremental chain still needs
        frontier = list(retained)
        while frontier:
            s = frontier.pop()
            try:
                man = self._manifest(s)
            except FileNotFoundError:
                continue
            base = man.get("base_step")
            if base is not None and base not in retained:
                retained.add(base)
                frontier.append(base)
        for s in steps:
            if s in retained:
                continue
            for suffix in (".json", ".npz"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass


def _sketch_delta(delta: np.ndarray, rank: int
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """SVD-truncate ``delta`` to ``P Qᵀ`` with rank ≤ ``rank``.

    Returns (P, Q, relative Frobenius truncation error).  The factored
    payload is the LINVIEW representation: ``(n + m)·r`` floats instead
    of ``n·m``.
    """
    u, s, vt = np.linalg.svd(delta, full_matrices=False)
    total = float(np.sqrt(np.sum(s * s)))
    if total == 0.0:
        return (np.zeros((delta.shape[0], 0), np.float32),
                np.zeros((delta.shape[1], 0), np.float32), 0.0)
    r = min(rank, int(np.sum(s > 0)))
    r = max(r, 1)
    rel = float(np.sqrt(np.sum(s[r:] * s[r:]))) / total
    P = (u[:, :r] * s[:r]).astype(np.float32)
    Q = vt[:r].T.astype(np.float32)
    return P, Q, rel
