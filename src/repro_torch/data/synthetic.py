"""Deterministic synthetic data pipeline.

No datasets ship offline, so the pipeline synthesises reproducible
images for the YOLO path (a copy of the JAX package's ``ImageStream``;
its LM ``TokenStream`` waits for the LM slice of the port).
Determinism is absolute: batch ``i`` is a pure function of (seed, i) —
which is what makes checkpoint/restart exact (the loader state is just
an integer) and elastic resharding trivial.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
