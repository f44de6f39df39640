"""Synthetic gray-8 images for runs on machines that hold no image corpus.

``chip_smoke.py`` and ``kernel_probe.py`` build their Kodak-shaped inputs
from :func:`synth_image` and a numpy seed.
"""

from __future__ import annotations

import numpy as np


def synth_image(rng, h: int, w: int) -> np.ndarray:
    """A natural-looking gray-8 plane: smooth gradients, texture and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy /= h
    xx /= w
    img = 128.0 + 50.0 * (xx - 0.5) * rng.uniform(-1, 1) + 40.0 * (yy - 0.5)
    for _ in range(4):  # low-frequency shading
        fx, fy = rng.uniform(0.5, 4.0, size=2)
        img += rng.uniform(10, 30) * np.sin(2 * np.pi * (fx * xx + fy * yy)
                                            + rng.uniform(0, 2 * np.pi))
    # a textured band
    band = (yy > rng.uniform(0.2, 0.5)) & (yy < rng.uniform(0.6, 0.9))
    tex = 12.0 * np.sin(2 * np.pi * (rng.uniform(20, 60) * xx)) \
        * np.sin(2 * np.pi * (rng.uniform(20, 60) * yy))
    img += np.where(band, tex, 0.0)
    img += rng.normal(0.0, 2.5, size=(h, w)).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)
