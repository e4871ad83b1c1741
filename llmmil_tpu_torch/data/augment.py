"""Host-side CT augmentations, numpy (the JAX package's ``data/augment.py``):
the reference's MONAI stack of a ±10° in-plane rotation (nearest, p=0.2),
Gaussian noise (σ=0.05, p=0.1) and a flip of each axis (p=0.2 each), drawn
from an explicit ``np.random.RandomState`` in the JAX package's order, so a
seed gives the same volumes in both packages.
"""

from __future__ import annotations

import math

import numpy as np


def rand_rotate(img: np.ndarray, rng: np.random.RandomState,
                prob: float = 0.2, max_deg: float = 10.0,
                mask: np.ndarray | None = None):
    """In-plane rotation by U(−10°, 10°), nearest-neighbour, applied jointly
    to image and mask."""
    if rng.rand() >= prob:
        return (img, mask) if mask is not None else img
    deg = rng.uniform(-max_deg, max_deg)
    out = _rotate_inplane_nearest(img, deg)
    if mask is not None:
        return out, _rotate_inplane_nearest(mask, deg)
    return out


def _rotate_inplane_nearest(img: np.ndarray, deg: float) -> np.ndarray:
    """Nearest-neighbour in-plane rotation about the slice centre, zeros
    outside — ``scipy.ndimage.rotate(order=0, reshape=False, 'constant')``
    semantics, as one vectorised gather."""
    d, h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rad = math.radians(deg)
    cos, sin = math.cos(rad), math.sin(rad)
    yy, xx = np.meshgrid(np.arange(h) - cy, np.arange(w) - cx,
                         indexing="ij")
    # output←input inverse mapping (rotate the output grid by −deg)
    ys_f = cos * yy + sin * xx + cy
    xs_f = -sin * yy + cos * xx + cx
    ys = np.rint(ys_f).astype(np.intp)
    xs = np.rint(xs_f).astype(np.intp)
    # scipy 'constant' marks any UNROUNDED coordinate outside [0, size-1]
    # as cval, even where it would round in-bounds — match that exactly
    # (pixel-exact vs scipy over random angles, see test_augment_parity)
    valid = (ys_f >= 0) & (ys_f <= h - 1) & (xs_f >= 0) & (xs_f <= w - 1)
    out = img[:, ys.clip(0, h - 1), xs.clip(0, w - 1)]
    out[:, ~valid] = 0
    return out


def rand_gaussian_noise(img: np.ndarray, rng: np.random.RandomState,
                        prob: float = 0.1, std: float = 0.05) -> np.ndarray:
    if rng.rand() >= prob:
        return img
    # a float32 Generator seeded from the sample's RandomState, drawn one
    # slice at a time so that the noise buffer stays in cache
    gen = np.random.Generator(np.random.PCG64(rng.randint(2 ** 31)))
    if img.ndim < 2:
        noise = gen.standard_normal(img.shape, dtype=np.float32) * std
        return img + noise.astype(img.dtype)
    out = np.empty(img.shape, dtype=img.dtype)
    buf = np.empty(img.shape[1:], dtype=np.float32)
    for i in range(img.shape[0]):
        gen.standard_normal(img.shape[1:], dtype=np.float32, out=buf)
        buf *= std
        np.add(img[i], buf, out=out[i], casting="unsafe")
    return out


def rand_flip(img: np.ndarray, rng: np.random.RandomState,
              prob: float = 0.2, mask: np.ndarray | None = None):
    """Independent flip per axis with p=0.2."""
    for ax in range(img.ndim):
        if rng.rand() < prob:
            img = np.flip(img, axis=ax)
            if mask is not None:
                mask = np.flip(mask, axis=ax)
    img = np.ascontiguousarray(img)
    if mask is not None:
        return img, np.ascontiguousarray(mask)
    return img


def augment_ct(img: np.ndarray, rng: np.random.RandomState,
               mask: np.ndarray | None = None):
    """Full train-time CT augmentation chain."""
    if mask is not None:
        img, mask = rand_rotate(img, rng, mask=mask)
        img = rand_gaussian_noise(img, rng)
        img, mask = rand_flip(img, rng, mask=mask)
        return img, mask
    img = rand_rotate(img, rng)
    img = rand_gaussian_noise(img, rng)
    return rand_flip(img, rng)
