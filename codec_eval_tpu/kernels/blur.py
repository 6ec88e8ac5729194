"""Separable Gaussian blur + 2x2 box downsample as XLA-friendly JAX kernels.

These are the workhorse ops under every perceptual metric (SSIMULACRA2's
multi-scale moments, DSSIM's windowed statistics).  Layout convention is
planar ``(C, H, W)``; the channel axis doubles as a fusion axis — callers
stack every plane that needs the same blur (mu/sigma moments of both images)
into one ``C`` so a single pass computes all windowed moments (SURVEY.md §7
step 8).

Equivalent behavior in the reference lives inside the external ``fast-ssim2``
/ ``butteraugli`` crates (reference: src/metrics/ssimulacra2.rs:96,
src/metrics/butteraugli.rs:70-80); there it is recursive-IIR SIMD code.  Here
a truncated FIR Gaussian is a static-shape stencil that XLA fuses into
elementwise loop fusions, while an IIR scan would serialize one axis.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def gaussian_taps(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1-D Gaussian taps.

    Radius defaults to 4.5*sigma: truncated tail mass < 4e-6 per side,
    orders of magnitude below metric tolerance (the reference's recursive
    Gaussian is itself only a ~1e-3-accurate Gaussian approximation), while
    cutting ~20% of the blur work relative to a 6-sigma support.
    """
    if radius is None:
        radius = max(1, int(math.ceil(4.5 * sigma)))
    n = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (n / sigma) ** 2)
    taps /= taps.sum()
    return taps.astype(np.float32)


def blur_separable(planes: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Gaussian-blur a stack of planes ``(C, H, W)`` with zero-padded borders.

    Zero boundary extension mirrors the reference kernels' recursive filters,
    which treat samples outside the image as zero.  Each pass is K shifted
    multiply-adds over a zero-padded array, which XLA fuses with the
    surrounding metric math.
    """
    taps = gaussian_taps(sigma)
    k = len(taps)
    r = k // 2
    c, h, w = planes.shape
    xp = jnp.pad(planes, ((0, 0), (r, r), (0, 0)))
    out = taps[0] * xp[:, 0:h, :]
    for i in range(1, k):
        out = out + taps[i] * xp[:, i : i + h, :]
    xp = jnp.pad(out, ((0, 0), (0, 0), (r, r)))
    out = taps[0] * xp[:, :, 0:w]
    for i in range(1, k):
        out = out + taps[i] * xp[:, :, i : i + w]
    return out


def downscale_by_2(planes: jnp.ndarray) -> jnp.ndarray:
    """2x2 box downscale with edge-clamped odd borders, on ``(C, H, W)``.

    Matches the reference metric's pyramid step: output size is ceil(n/2) and
    out-of-range source taps clamp to the last row/column (SURVEY.md §2.4 —
    fast-ssim2 half-res pyramid).
    """
    c, h, w = planes.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        planes = jnp.pad(planes, ((0, 0), (0, ph), (0, pw)), mode="edge")
    _, h2, w2 = planes.shape
    return planes.reshape(c, h2 // 2, 2, w2 // 2, 2).mean(axis=(2, 4))
