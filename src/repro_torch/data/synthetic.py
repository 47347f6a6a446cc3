"""Deterministic synthetic data pipeline.

No datasets ship offline, so the pipeline synthesises reproducible
streams (copies of the JAX package's): token sequences from a seeded
Zipf-ish LM mixture (so cross-entropy actually decreases during a
training run) and images for the YOLO path. Both are numpy and give the
JAX package's batches bit for bit. Determinism is absolute: batch ``i`` is a pure function of (seed, i) —
which is what makes checkpoint/restart exact (the loader state is just
an integer) and elastic resharding trivial.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Markov-ish token stream with learnable structure."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    microbatches: int = 1
    n_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        k = min(self.n_states, self.vocab)
        # sparse-ish transition table: each state prefers ~8 tokens
        self._emit = rng.integers(0, self.vocab,
                                  size=(k, 8)).astype(np.int64)
        self._trans = rng.integers(0, k, size=(k, 8)).astype(np.int64)

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        """Batch ``index`` — pure function of (seed, index), each leaf
        microbatch-shaped (microbatches, batch / microbatches, seq_len)."""
        rng = np.random.default_rng((self.seed, index))
        B, T = self.batch, self.seq_len
        k = self._emit.shape[0]
        state = rng.integers(0, k, size=B)
        toks = np.empty((B, T), np.int32)
        choice = rng.integers(0, 8, size=(B, T))
        for t in range(T):
            toks[:, t] = self._emit[state, choice[:, t]]
            state = self._trans[state, choice[:, t]]
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        out = {"tokens": toks, "labels": labels.astype(np.int32)}
        if self.microbatches > 1:
            out = {kk: v.reshape(self.microbatches,
                                 B // self.microbatches, T)
                   for kk, v in out.items()}
        else:
            out = {kk: v[None] for kk, v in out.items()}
        return out


@dataclasses.dataclass
class ImageStream:
    """Synthetic NHWC images with box-like structure (YOLO path)."""
    img_size: int
    batch: int
    channels: int = 3
    seed: int = 0

    def batch_at(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        B, S, C = self.batch, self.img_size, self.channels
        img = rng.normal(0.45, 0.2, size=(B, S, S, C)).astype(np.float32)
        # paint a few rectangles so detect heads see structure
        for b in range(B):
            for _ in range(rng.integers(1, 5)):
                x0, y0 = rng.integers(0, S - 8, size=2)
                w, h = rng.integers(4, max(S // 4, 5), size=2)
                img[b, y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1, size=C)
        return np.clip(img, 0.0, 1.0)

    def frames(self, n: int, start_batch: int = 0):
        """Yield ``n`` single images in arrival order — the per-request
        view a serving front-end admits one frame at a time (frame
        ``i`` is row ``i % batch`` of batch ``start_batch + i //
        batch``, so determinism is preserved)."""
        index, yielded = start_batch, 0
        while yielded < n:
            for img in self.batch_at(index):
                if yielded >= n:
                    return
                yield img
                yielded += 1
            index += 1
