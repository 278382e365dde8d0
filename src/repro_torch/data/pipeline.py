"""Deterministic synthetic model batches, numpy only.

The counterpart of the JAX package's ``data/pipeline.py`` for serving and
the tests: batch ``step`` is a pure function of ``(seed, step, host)``,
drawn draw for draw as the reference draws it, so both packages see the
same tokens, patches and frames.  Tokens are Zipf-distributed unigrams
with a short motif copied later in the sequence; a vlm batch carries
``patches`` (B, n_patches, frontend_dim) before its text, an audio batch
``frames`` (B, S, frontend_dim) with masked-prediction targets.
:class:`TokenPipeline` prefetches them on a thread for a training loop.
:func:`make_batch_specs` gives the dry-run meta stand-ins of every input.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.runtime import resolve_device


def _rng_for_step(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, host)))


def synth_tokens(rng: np.random.Generator, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """(batch, seq) int32 tokens in [1, vocab - 2]: Zipf unigrams, and from
    seq 64 on a 16-token window repeated half a sequence later."""
    zipf = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (zipf % (vocab - 2)) + 1
    if seq >= 64:
        start = rng.integers(0, seq // 4, size=batch)
        for b in range(batch):
            w = toks[b, start[b]:start[b] + 16]
            dst = seq // 2 + start[b]
            toks[b, dst:dst + 16] = w[:max(0, min(16, seq - dst))]
    return toks.astype(np.int32)


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                step: int = 0, host: int = 0, num_hosts: int = 1
                ) -> Dict[str, np.ndarray]:
    """The host-local slice of global batch ``step``: ``{"tokens"}``, plus
    ``"patches"`` for a vlm (text of ``max(16, seq_len - n_patches)``
    tokens), or ``{"frames", "targets", "mask"}`` for audio."""
    if shape.global_batch % num_hosts:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"split over {num_hosts} hosts")
    b = shape.global_batch // num_hosts
    s = shape.seq_len
    rng = _rng_for_step(seed, step, host)
    if cfg.family == "vlm":
        text_len = max(16, s - cfg.n_patches)
        return {
            "patches": rng.normal(size=(b, cfg.n_patches, cfg.frontend_dim)
                                  ).astype(np.float32),
            "tokens": synth_tokens(rng, b, text_len, cfg.vocab),
        }
    if cfg.family == "audio":
        mask = rng.random((b, s)) < 0.08
        return {
            "frames": rng.normal(size=(b, s, cfg.frontend_dim)
                                 ).astype(np.float32),
            "targets": rng.integers(0, cfg.vocab, size=(b, s)
                                    ).astype(np.int32),
            "mask": mask,
        }
    return {"tokens": synth_tokens(rng, b, s, cfg.vocab)}


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                     dtype=torch.int32) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of the global batch
    (the dry-run's pattern): the reference's keys, shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    if cfg.family == "vlm":
        text_len = max(16, s - cfg.n_patches)
        return {"patches": spec((b, cfg.n_patches, cfg.frontend_dim),
                                torch.float32),
                "tokens": spec((b, text_len), dtype)}
    if cfg.family == "audio":
        return {"frames": spec((b, s, cfg.frontend_dim), torch.float32),
                "targets": spec((b, s), dtype),
                "mask": spec((b, s), torch.bool)}
    return {"tokens": spec((b, s), dtype)}


class TokenPipeline:
    """Double-buffered iterator over :func:`synth_batch`'s batches
    ``start_step``, ``start_step + 1``, ..., as dicts of tensors on
    ``device`` (``None``: the card; raises without one): a daemon thread
    draws and uploads up to ``prefetch`` of them ahead.  :meth:`close`
    stops the thread (and joins it); the iterator then stops too."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, start_step: int = 0, host: int = 0,
                 num_hosts: int = 1, prefetch: int = 2, device=None):
        self.device = resolve_device(device)
        self.cfg, self.shape = cfg, shape
        self.seed, self.host, self.num_hosts = seed, host, num_hosts
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer,
                                        args=(start_step,), daemon=True)
        self._thread.start()

    def _producer(self, step: int) -> None:
        while not self._stop.is_set():
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in synth_batch(
                         self.cfg, self.shape, seed=self.seed, step=step,
                         host=self.host, num_hosts=self.num_hosts).items()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while not self._stop.is_set():
            try:
                out = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self.step += 1
            return out
        raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and wait for it (at most ``timeout`` s)."""
        self._stop.set()
        self._thread.join(timeout)
