"""Per-image content heuristics as one fused device kernel.

Behavioral port of reference: crates/codec-compare/src/image_heuristics.rs:
23-300 — the 26 per-image features used for encoder-selection prediction
(luminance stats, Sobel-ish edges, 8x8 block-variance buckets, color and
saturation stats, adjacent-pixel frequency energies, 3x3 local contrast,
directional complexity).

The reference computes these with scalar Rust loops per image; here the
whole feature stack is ONE jitted XLA program of vectorized slices /
reshapes / reductions — and ``heuristics_batch`` maps it over a corpus
batch, which is the device-side replacement for its per-image CLI loop.
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

#: Feature order for CSV output (matches the reference's struct order).
FEATURE_NAMES = [
    "mean_luminance",
    "luminance_variance",
    "luminance_std",
    "edge_strength_mean",
    "edge_strength_max",
    "edge_density",
    "flat_block_pct",
    "low_var_block_pct",
    "mid_var_block_pct",
    "high_var_block_pct",
    "detail_block_pct",
    "block_variance_mean",
    "block_variance_std",
    "color_variance",
    "saturation_mean",
    "saturation_std",
    "high_freq_energy",
    "low_freq_energy",
    "freq_ratio",
    "local_contrast_mean",
    "local_contrast_std",
    "horizontal_complexity",
    "vertical_complexity",
    "diagonal_complexity",
]


def compute_heuristics(rgb_u8: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """All features for one (H, W, 3) u8 image.  Jittable / vmappable."""
    rgb = rgb_u8.astype(jnp.float32)
    h, w = rgb.shape[0], rgb.shape[1]
    pixels = h * w

    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]

    out: Dict[str, jnp.ndarray] = {}

    # Luminance.
    mean_lum = gray.mean()
    lum_var = ((gray - mean_lum) ** 2).mean()
    out["mean_luminance"] = mean_lum
    out["luminance_variance"] = lum_var
    out["luminance_std"] = jnp.sqrt(lum_var)

    # Edges: central differences on the interior, magnitude sqrt(gx^2+gy^2).
    interior = gray[1:-1, 1:-1]
    gx = gray[1:-1, 2:] - gray[1:-1, :-2]
    gy = gray[2:, 1:-1] - gray[:-2, 1:-1]
    strength = jnp.sqrt(gx * gx + gy * gy)
    out["edge_strength_mean"] = strength.mean()
    out["edge_strength_max"] = strength.max()
    out["edge_density"] = (strength > 30.0).mean()

    # 8x8 block variances.
    bh, bw = h // 8, w // 8
    blocks = gray[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    bmean = blocks.mean(axis=(1, 3), keepdims=True)
    bvar = ((blocks - bmean) ** 2).mean(axis=(1, 3)).reshape(-1)
    out["flat_block_pct"] = 100.0 * (bvar < 100.0).mean()
    out["low_var_block_pct"] = 100.0 * (bvar < 500.0).mean()
    out["mid_var_block_pct"] = 100.0 * ((bvar >= 500.0) & (bvar < 2000.0)).mean()
    out["high_var_block_pct"] = 100.0 * ((bvar >= 2000.0) & (bvar < 5000.0)).mean()
    out["detail_block_pct"] = 100.0 * (bvar >= 5000.0).mean()
    bv_mean = bvar.mean()
    out["block_variance_mean"] = bv_mean
    out["block_variance_std"] = jnp.sqrt(((bvar - bv_mean) ** 2).mean())

    # Color: mean of per-channel variances.
    ch_mean = rgb.mean(axis=(0, 1), keepdims=True)
    out["color_variance"] = ((rgb - ch_mean) ** 2).mean(axis=(0, 1)).mean()

    # Saturation: (max - min) / max per pixel.
    cmax = rgb.max(axis=-1)
    cmin = rgb.min(axis=-1)
    sat = jnp.where(cmax > 0.0, (cmax - cmin) / jnp.maximum(cmax, 1e-9), 0.0)
    sat_mean = sat.mean()
    out["saturation_mean"] = sat_mean
    out["saturation_std"] = jnp.sqrt(((sat - sat_mean) ** 2).mean())

    # Frequency proxy: fraction of small / large horizontal transitions.
    diff = jnp.abs(gray[:, 1:] - gray[:, :-1])
    low = (diff < 10.0).mean()
    high = (diff > 30.0).mean()
    out["low_freq_energy"] = low
    out["high_freq_energy"] = high
    out["freq_ratio"] = jnp.where(low > 0.0, high / jnp.maximum(low, 1e-12), high)

    # Local contrast: 3x3 max - min via stacked shifts.
    shifts = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifts.append(gray[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx])
    stack = jnp.stack(shifts)
    contrast = stack.max(axis=0) - stack.min(axis=0)
    c_mean = contrast.mean()
    out["local_contrast_mean"] = c_mean
    out["local_contrast_std"] = jnp.sqrt(((contrast - c_mean) ** 2).mean())

    # Directional complexity.
    out["horizontal_complexity"] = jnp.abs(gx).mean()
    out["vertical_complexity"] = jnp.abs(gy).mean()
    diag = gray[2:, 2:] - gray[:-2, :-2]
    out["diagonal_complexity"] = jnp.abs(diag).mean()

    return out


@jax.jit
def _compute_jit(rgb_u8: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    return compute_heuristics(rgb_u8)


def heuristics_one(rgb_u8: np.ndarray) -> Dict[str, float]:
    return {k: float(v) for k, v in _compute_jit(jnp.asarray(rgb_u8)).items()}


def heuristics_batch(batch_u8: np.ndarray) -> List[Dict[str, float]]:
    """(N, H, W, 3) batch -> list of feature dicts (one fused device pass)."""
    out = jax.jit(jax.vmap(compute_heuristics))(jnp.asarray(batch_u8))
    out = {k: np.asarray(v) for k, v in out.items()}
    n = batch_u8.shape[0]
    return [{k: float(out[k][i]) for k in out} for i in range(n)]
