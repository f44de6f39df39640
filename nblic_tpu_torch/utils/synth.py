"""Synthetic gray-8 images for runs on machines that hold no image corpus.

``chip_smoke.py`` and ``kernel_probe.py`` build their Kodak-shaped inputs
from :func:`synth_image` and a numpy seed; :func:`edge_images` are the
extremes the profile-3 walks are held to, on the CPU and on the card.
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


def edge_images() -> list[np.ndarray]:
    """Images that drive the profile-3 chains to their ends: a 0/255
    checkerboard, a ramp saturated at both ends, a constant image and
    1-pixel-wide vertical stripes of 0 and 255, each 24x16 (portrait, so
    they share one batch shape)."""
    yy, xx = np.mgrid[0:24, 0:16]
    checker = np.where((yy + xx) % 2, 255, 0)
    ramp = np.clip(24 * xx + 16 * yy - 160, 0, 255)
    flat = np.full(yy.shape, 255)
    stripes = np.where(xx % 2, 255, 0)
    return [a.astype(np.uint8) for a in (checker, ramp, flat, stripes)]
