"""Seeded test images: glyph-like gray+alpha inputs of any size.

The reference ships one 200x200 sample; tests and the on-card smoke need
inputs of many sizes that are reproducible from a seed and exercise every
byte value around the threshold.
"""

from __future__ import annotations

import numpy as np


def glyph_image(seed: int, shape=(200, 200)) -> np.ndarray:
    """(H, W, 2) uint8 gray+alpha image from a seed. The gray channel holds
    dark anti-aliased strokes (discs and a bar) on white, the alpha
    channel an independent set of blobs; both carry noise so that the
    threshold meets every byte value. Features scale with the image."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]

    def coverage(n_discs):
        c = np.zeros((h, w), np.float32)
        for _ in range(n_discs):
            cy, cx = rng.uniform(0.15, 0.85, 2) * (h, w)
            r = rng.uniform(0.06, 0.2) * min(h, w)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            np.maximum(c, np.clip(r - d + 0.5, 0.0, 1.0), out=c)
        return c

    ink = coverage(4)
    half = max(h // 32, 1)
    bar_y = int(rng.uniform(0.3, 0.7) * h)
    ink[max(bar_y - half, 0) : bar_y + half, w // 5 : 4 * w // 5] = 1.0
    gray = 255.0 * (1.0 - ink) + rng.normal(0, 6, (h, w)).astype(np.float32)
    alpha = 255.0 * coverage(3) + rng.normal(0, 6, (h, w)).astype(np.float32)
    img = np.stack([gray, alpha], axis=-1)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)
