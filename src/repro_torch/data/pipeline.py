"""Deterministic synthetic model batches, numpy only.

The counterpart of the JAX package's ``data/pipeline.py`` for serving and
the tests: batch ``step`` is a pure function of ``(seed, step, host)``,
drawn draw for draw as the reference draws it, so both packages see the
same tokens, patches and frames.  Tokens are Zipf-distributed unigrams
with a short motif copied later in the sequence; a vlm batch carries
``patches`` (B, n_patches, frontend_dim) before its text, an audio batch
``frames`` (B, S, frontend_dim) with masked-prediction targets.  The
reference's dry-run specs and its prefetching training loader wait for
the training slice (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


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
