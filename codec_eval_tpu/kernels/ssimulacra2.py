"""SSIMULACRA2 as a fused, batchable JAX/XLA pipeline.

Accelerator rebuild of the scoring path the reference delegates to the SIMD
``fast-ssim2`` crate (reference: src/metrics/ssimulacra2.rs:96,
crates/codec-iter/src/eval.rs:138-149) and, on GPU, to ``ssimulacra2-cuda``
(crates/codec-iter/src/gpu.rs).  Design:

- planar ``(3, H, W)`` f32 layout;
- the 6-scale pyramid is unrolled at trace time (static shapes per bucket);
- per scale, all five windowed moments (mu1, mu2, s11, s22, s12) are computed
  by ONE separable-blur pass over a 15-plane stack — the fusion the reference
  achieves with hand-written SIMD;
- the reference image's side of the work (pyramid, XYB, mu1, s11) is
  precomputed once and reused across every distorted candidate, mirroring
  ``Ssimulacra2Reference`` (crates/codec-iter/src/eval.rs:142);
- everything is traceable under jit/vmap/shard_map; batching over candidates
  is ``vmap`` with the reference precompute broadcast.

Algorithm (public SSIMULACRA 2.1): sRGB -> linear RGB -> per-scale 2x2 box
downsample -> XYB (positive-shifted) -> Gaussian windowed SSIM + ringing /
detail-loss error maps -> 1-norm & 4-norm pooling -> 108-feature weighted
score.  See ssimulacra2_weights.py for scoring constants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .blur import blur_separable, downscale_by_2
from .color import linear_rgb_to_xyb, srgb_u8_to_linear
from . import ssimulacra2_weights as W

NUM_SCALES = 6
SIGMA = 1.5
C2 = 0.0009


def _to_positive_xyb(linear_planes: jnp.ndarray) -> jnp.ndarray:
    """Linear RGB planes (3, H, W) -> positive-shifted XYB planes.

    The shift makes all channels positive so the SSIM mean term can use the
    simplified ``1 - (mu1-mu2)^2`` form (public v2.1 `MakePositiveXYB`):
    B' = B - Y + 0.55, X' = X*14 + 0.42, Y' = Y + 0.01.
    """
    rgb = jnp.moveaxis(linear_planes, 0, -1)  # (H, W, 3)
    xyb = linear_rgb_to_xyb(rgb)
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    out = jnp.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55], axis=0)
    return out


class Ssimulacra2Reference(NamedTuple):
    """Per-scale precomputed reference data, reused across candidates.

    Mirrors fast-ssim2's ``Ssimulacra2Reference`` precompute
    (crates/codec-iter/src/eval.rs:138-149): computing this once per source
    image and scoring many encodes against it is the dominant-cost saving in
    a quality sweep.
    """

    xyb: tuple  # per scale: (3, h, w) positive XYB
    mu: tuple  # per scale: blur(xyb)
    sqblur: tuple  # per scale: blur(xyb*xyb)


def precompute_reference(
    ref_u8: jnp.ndarray, lin_planar: jnp.ndarray | None = None
) -> Ssimulacra2Reference:
    """ref_u8: (H, W, 3) uint8 sRGB.  ``lin_planar`` optionally supplies its
    (3, H, W) linear RGB so callers can share one staging pass."""
    linear = (
        lin_planar
        if lin_planar is not None
        else jnp.moveaxis(srgb_u8_to_linear(ref_u8), -1, 0)
    )  # (3, H, W)
    xybs, mus, sqs = [], [], []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb = _to_positive_xyb(linear)
        stacked = jnp.concatenate([xyb, xyb * xyb], axis=0)  # (6, h, w)
        blurred = blur_separable(stacked, SIGMA)
        xybs.append(xyb)
        mus.append(blurred[:3])
        sqs.append(blurred[3:])
    return Ssimulacra2Reference(tuple(xybs), tuple(mus), tuple(sqs))


def _scale_features(
    xyb1: jnp.ndarray,
    mu1: jnp.ndarray,
    s11: jnp.ndarray,
    xyb2: jnp.ndarray,
) -> jnp.ndarray:
    """Features for one scale: (3 channels, 2 norms, 3 maps) -> (3, 2, 3)."""
    stacked = jnp.concatenate([xyb2, xyb2 * xyb2, xyb1 * xyb2], axis=0)  # (9,h,w)
    blurred = blur_separable(stacked, SIGMA)
    mu2, s22, s12 = blurred[:3], blurred[3:6], blurred[6:9]

    mu11 = mu1 * mu1
    mu22 = mu2 * mu2
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + C2
    denom_s = (s11 - mu11) + (s22 - mu22) + C2
    d = jnp.maximum(1.0 - (num_m * num_s) / denom_s, 0.0)
    ssim_1 = d.mean(axis=(1, 2))
    ssim_4 = jnp.sqrt(jnp.sqrt((d**4).mean(axis=(1, 2))))

    # Ringing-artifact / detail-loss maps (public v2.1 `EdgeDiffMap`):
    # ratio of local edge energy in distorted vs reference.
    detail1 = jnp.abs(xyb1 - mu1)
    detail2 = jnp.abs(xyb2 - mu2)
    d1 = (1.0 + detail2) / (1.0 + detail1) - 1.0
    artifact = jnp.maximum(d1, 0.0)
    detail_lost = jnp.maximum(-d1, 0.0)
    art_1 = artifact.mean(axis=(1, 2))
    art_4 = jnp.sqrt(jnp.sqrt((artifact**4).mean(axis=(1, 2))))
    det_1 = detail_lost.mean(axis=(1, 2))
    det_4 = jnp.sqrt(jnp.sqrt((detail_lost**4).mean(axis=(1, 2))))

    # (3, 2, 3): channel x norm x (ssim, artifact, detail)
    return jnp.stack(
        [
            jnp.stack([ssim_1, art_1, det_1], axis=-1),
            jnp.stack([ssim_4, art_4, det_4], axis=-1),
        ],
        axis=1,
    )


def features_against_reference(
    ref: Ssimulacra2Reference, dist_u8: jnp.ndarray
) -> jnp.ndarray:
    """All 108 features of a distorted candidate vs a precomputed reference.

    Returns features ordered channel-major: (3, 6, 2, 3) -> flat (108,)
    matching the public weight-vector indexing.
    """
    return features_from_linear(
        ref, jnp.moveaxis(srgb_u8_to_linear(dist_u8), -1, 0)
    )


def features_from_linear(
    ref: Ssimulacra2Reference, linear: jnp.ndarray
) -> jnp.ndarray:
    """Like ``features_against_reference`` but from (3, H, W) linear RGB —
    lets the all-metric scorer share one sRGB->linear staging pass across
    metrics instead of reconverting per metric."""
    per_scale = []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb2 = _to_positive_xyb(linear)
        per_scale.append(
            _scale_features(ref.xyb[scale], ref.mu[scale], ref.sqblur[scale], xyb2)
        )
    feats = jnp.stack(per_scale, axis=1)  # (3, 6, 2, 3)
    return feats.reshape(-1)


def score_from_features(features: jnp.ndarray) -> jnp.ndarray:
    """108 features -> SSIMULACRA2 score in (-inf, 100]."""
    weights = jnp.asarray(W.WEIGHTS_V21, dtype=features.dtype)
    s = jnp.sum(weights * jnp.abs(features), axis=-1) * W.SCALE_FACTOR
    v = (W.CUBIC_A * s * s + W.CUBIC_B * s + W.CUBIC_C) * s
    score = jnp.where(
        v > 0.0,
        100.0 - 10.0 * jnp.power(jnp.maximum(v, 1e-30), W.POWER),
        100.0,
    )
    return score


def ssimulacra2(ref_u8: jnp.ndarray, dist_u8: jnp.ndarray) -> jnp.ndarray:
    """Score a single (H, W, 3) uint8 sRGB pair.  Jittable.

    Drop-in equivalent of ``calculate_ssimulacra2``
    (reference: src/metrics/ssimulacra2.rs:59).
    """
    ref = precompute_reference(ref_u8)
    score = score_from_features(features_against_reference(ref, dist_u8))
    # Byte-identical pairs must score exactly 100.0 (the reference kernel
    # produces exact zeros because both images flow through one code path;
    # our reference-precompute reuse makes that bitwise guarantee explicit).
    identical = jnp.all(ref_u8 == dist_u8)
    return jnp.where(identical, jnp.asarray(100.0, score.dtype), score)


def ssimulacra2_batch(ref_u8: jnp.ndarray, dist_batch_u8: jnp.ndarray) -> jnp.ndarray:
    """Score a batch of candidates (N, H, W, 3) against one reference.

    The reference precompute is shared across the batch — the analog of
    reusing ``Ssimulacra2Reference`` across a quality sweep.
    """
    return ssimulacra2_batch_pre(
        precompute_reference(ref_u8), ref_u8, dist_batch_u8
    )


def ssimulacra2_batch_pre(
    ref: Ssimulacra2Reference,
    ref_u8: jnp.ndarray,
    dist_batch_u8: jnp.ndarray,
    lin_planar: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Like ``ssimulacra2_batch`` but with the reference pyramid already
    computed — sweeps precompute it once per image (in its own program) and
    amortize it across every candidate chunk dispatch.

    ``lin_planar`` optionally supplies the candidates' (N, 3, H, W) linear
    RGB (exactly ``vmap(moveaxis(srgb_u8_to_linear))`` of the batch) so the
    all-metric scorer stages it once for every metric.
    """

    def one(d, lin):
        feats = (
            features_from_linear(ref, lin)
            if lin is not None
            else features_against_reference(ref, d)
        )
        score = score_from_features(feats)
        identical = jnp.all(ref_u8 == d)
        return jnp.where(identical, jnp.asarray(100.0, score.dtype), score)

    if lin_planar is None:
        return jax.vmap(lambda d: one(d, None))(dist_batch_u8)
    return jax.vmap(one)(dist_batch_u8, lin_planar)
