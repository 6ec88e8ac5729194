"""Masked SSIMULACRA2 / PSNR: score mixed-size images with ONE compiled program.

The reference recompiles nothing (interpreted CPU loops, rayon fan-out:
crates/codec-eval-cli/src/bin/rd_calibrate.rs:184-216); under XLA every
distinct image shape is a distinct compiled program, so a corpus of
heterogeneous sizes either compiles per shape (the per-bucket strategy in
``parallel/corpus_runner.py``) or — this module — pads every image to a
shared bucket shape and masks the computation.

Why this is *exact* and not an approximation.  The pipeline has exactly two
spatial operators, with different boundary semantics:

- ``blur_separable`` uses ZERO boundary extension.  If the padded array is
  exactly zero beyond the valid region, blur at any valid pixel reads the
  same zeros the exact-shape kernel synthesizes.  We zero-pad the input and
  re-zero the XYB planes (whose transform maps 0 -> nonzero constants) with
  a validity mask before every blur.
- ``downscale_by_2`` EDGE-CLAMPS odd dims (duplicates the last row/col).
  On the zero-padded array an odd valid dim instead averages the last valid
  row with a zero row — exactly half the clamped value — so we multiply
  that single output row/col by 2 (by 4 at a doubly-odd corner).  This
  keeps the result bit-equal at valid pixels AND keeps the padding region
  exactly zero, so the invariant holds inductively down the pyramid with
  valid dims ``ceil(h / 2**s)``.

With per-pixel maps exact at valid pixels, the mean / 4-norm poolings just
need masked sums over the true pixel count.  Verified against the
exact-shape kernel in tests/test_masked_scoring.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .blur import blur_separable, downscale_by_2
from .color import srgb_u8_to_linear
from .ssimulacra2 import (
    C2,
    NUM_SCALES,
    SIGMA,
    _to_positive_xyb,
    score_from_features,
)


def pad_to_bucket(img_u8: np.ndarray, h_pad: int, w_pad: int) -> np.ndarray:
    """Zero-pad (H, W, 3) uint8 to (h_pad, w_pad, 3) on the host."""
    h, w = img_u8.shape[:2]
    if h > h_pad or w > w_pad:
        raise ValueError(f"image ({h}x{w}) larger than bucket ({h_pad}x{w_pad})")
    return np.pad(img_u8, ((0, h_pad - h), (0, w_pad - w), (0, 0)))


def _valid_mask(h: int, w: int, vh: jnp.ndarray, vw: jnp.ndarray) -> jnp.ndarray:
    """(h, w) float mask: 1.0 where (row < vh) & (col < vw)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return ((rows < vh) & (cols < vw)).astype(jnp.float32)


def _downscale_masked(planes: jnp.ndarray, vh: jnp.ndarray, vw: jnp.ndarray):
    """2x2 box downscale of a zero-beyond-valid array, corrected so valid
    pixels match the exact-shape edge-clamped downscale.  Returns the new
    planes and the new valid dims ``ceil(v/2)``."""
    out = downscale_by_2(planes)  # bucket dims are even: no static pad
    h2, w2 = out.shape[1], out.shape[2]
    ri = jax.lax.broadcasted_iota(jnp.int32, (h2, w2), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (h2, w2), 1)
    rfix = jnp.where((vh % 2 == 1) & (ri == vh // 2), 2.0, 1.0)
    cfix = jnp.where((vw % 2 == 1) & (ci == vw // 2), 2.0, 1.0)
    return out * (rfix * cfix)[None], (vh + 1) // 2, (vw + 1) // 2


def _masked_moments(x: jnp.ndarray, mask: jnp.ndarray, count: jnp.ndarray):
    """Masked 1-norm and 4-norm over the trailing (h, w) dims of (C, h, w)."""
    m1 = jnp.sum(x * mask, axis=(1, 2)) / count
    m4 = jnp.sqrt(jnp.sqrt(jnp.sum((x**4) * mask, axis=(1, 2)) / count))
    return m1, m4


def _scale_features_masked(
    xyb1: jnp.ndarray,
    mu1: jnp.ndarray,
    s11: jnp.ndarray,
    xyb2: jnp.ndarray,
    mask: jnp.ndarray,
    count: jnp.ndarray,
) -> jnp.ndarray:
    """Masked twin of ssimulacra2._scale_features: (3, 2, 3) features.
    ``xyb1``/``xyb2`` must already be zero beyond the valid region."""
    stacked = jnp.concatenate([xyb2, xyb2 * xyb2, xyb1 * xyb2], axis=0)
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

    detail1 = jnp.abs(xyb1 - mu1)
    detail2 = jnp.abs(xyb2 - mu2)
    d1 = (1.0 + detail2) / (1.0 + detail1) - 1.0
    artifact = jnp.maximum(d1, 0.0)
    detail_lost = jnp.maximum(-d1, 0.0)

    m = mask[None]
    ssim_1, ssim_4 = _masked_moments(d, m, count)
    art_1, art_4 = _masked_moments(artifact, m, count)
    det_1, det_4 = _masked_moments(detail_lost, m, count)

    return jnp.stack(
        [
            jnp.stack([ssim_1, art_1, det_1], axis=-1),
            jnp.stack([ssim_4, art_4, det_4], axis=-1),
        ],
        axis=1,
    )


def ssimulacra2_masked(
    ref_pad_u8: jnp.ndarray,
    dist_pad_u8: jnp.ndarray,
    valid_h: jnp.ndarray,
    valid_w: jnp.ndarray,
) -> jnp.ndarray:
    """SSIMULACRA2 of a zero-padded pair; jittable, valid dims dynamic.

    ``ref_pad_u8``/``dist_pad_u8``: (H_pad, W_pad, 3) uint8, padded with
    ``pad_to_bucket``; bucket dims must be multiples of 32 so five pyramid
    halvings stay even.  ``valid_h``/``valid_w``: the true image dims (may
    be traced — one compiled program serves every size in the bucket).
    """
    # Clamp so out-of-range valid dims degrade to "whole padded array valid"
    # (well-defined) instead of silently mis-normalizing the masked means.
    vh = jnp.minimum(jnp.asarray(valid_h, jnp.int32), ref_pad_u8.shape[0])
    vw = jnp.minimum(jnp.asarray(valid_w, jnp.int32), ref_pad_u8.shape[1])
    lin1 = jnp.moveaxis(srgb_u8_to_linear(ref_pad_u8), -1, 0)
    lin2 = jnp.moveaxis(srgb_u8_to_linear(dist_pad_u8), -1, 0)
    per_scale = []
    for scale in range(NUM_SCALES):
        if scale:
            lin1, _, _ = _downscale_masked(lin1, vh, vw)
            lin2, vh, vw = _downscale_masked(lin2, vh, vw)
        mask = _valid_mask(lin1.shape[1], lin1.shape[2], vh, vw)
        count = (vh * vw).astype(jnp.float32)
        # The XYB transform maps 0 -> nonzero constants; re-zero the padding
        # so the zero-boundary blur sees what the exact-shape kernel sees.
        xyb1 = _to_positive_xyb(lin1) * mask[None]
        xyb2 = _to_positive_xyb(lin2) * mask[None]
        pre = blur_separable(jnp.concatenate([xyb1, xyb1 * xyb1], axis=0), SIGMA)
        per_scale.append(
            _scale_features_masked(xyb1, pre[:3], pre[3:], xyb2, mask, count)
        )
    feats = jnp.stack(per_scale, axis=1).reshape(-1)  # channel-major (108,)
    score = score_from_features(feats)
    identical = jnp.all(ref_pad_u8 == dist_pad_u8)
    return jnp.where(identical, jnp.asarray(100.0, score.dtype), score)


def _blur_window_masked(
    planes: jnp.ndarray, vh: jnp.ndarray, vw: jnp.ndarray
) -> jnp.ndarray:
    """dssim-core's 3-tap window blur, EXACT at valid pixels under dynamic
    valid dims.

    The exact-shape kernel edge-replicates (kernels/dssim._blur_window); on a
    zero-beyond-valid array the out-of-range tap reads 0 instead of the
    replicated edge sample, so we add ``tap * x`` back on the two boundary
    lines of each axis — bitwise the replicate result at every valid pixel.
    Rows/cols beyond valid receive spill garbage; callers mask at pooling.
    """
    from .dssim import _BLUR_TAPS

    a, b, _ = _BLUR_TAPS
    c, h, w = planes.shape
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)
    rfix = ((ri == 0).astype(planes.dtype) + (ri == vh - 1).astype(planes.dtype))
    xp = jnp.pad(planes, ((0, 0), (1, 1), (0, 0)))
    out = a * xp[:, 0:h, :] + b * xp[:, 1 : 1 + h, :] + a * xp[:, 2 : 2 + h, :]
    out = out + a * planes * rfix[None]
    cfix = ((ci == 0).astype(planes.dtype) + (ci == vw - 1).astype(planes.dtype))
    xp = jnp.pad(out, ((0, 0), (0, 0), (1, 1)))
    out2 = a * xp[:, :, 0:w] + b * xp[:, :, 1 : 1 + w] + a * xp[:, :, 2 : 2 + w]
    return out2 + a * out * cfix[None]


def dssim_masked(
    ref_pad_u8: jnp.ndarray,
    dist_pad_u8: jnp.ndarray,
    valid_h: jnp.ndarray,
    valid_w: jnp.ndarray,
) -> jnp.ndarray:
    """DSSIM of a zero-padded sRGB u8 pair; jittable, valid dims dynamic.

    Mirrors kernels/dssim.py (dssim-core recipe: half-res chroma at half
    weight, 3-tap replicate window) with the same exactness argument as
    ``ssimulacra2_masked``: Lab planes are re-zeroed beyond valid before
    every spatial op (Lab of black has nonzero chroma offsets), the window
    blur applies boundary-line corrections that reproduce edge replication
    exactly, and downscales apply the odd-dim correction.
    """
    from .dssim import (
        C1 as D_C1,
        C2 as D_C2,
        CHROMA_WEIGHT,
        SCALE_WEIGHTS,
        _linear_rgb_to_lab_planes,
    )

    vh = jnp.minimum(jnp.asarray(valid_h, jnp.int32), ref_pad_u8.shape[0])
    vw = jnp.minimum(jnp.asarray(valid_w, jnp.int32), ref_pad_u8.shape[1])
    mask0 = _valid_mask(ref_pad_u8.shape[0], ref_pad_u8.shape[1], vh, vw)
    lab1 = _linear_rgb_to_lab_planes(
        jnp.moveaxis(srgb_u8_to_linear(ref_pad_u8), -1, 0)
    ) * mask0[None]
    lab2 = _linear_rgb_to_lab_planes(
        jnp.moveaxis(srgb_u8_to_linear(dist_pad_u8), -1, 0)
    ) * mask0[None]

    def ssim_means_masked(p1, p2, pvh, pvw):
        mask = _valid_mask(p1.shape[1], p1.shape[2], pvh, pvw)
        count = (pvh * pvw).astype(jnp.float32)
        x1 = p1 * mask[None]
        x2 = p2 * mask[None]
        n = x1.shape[0]
        stacked = jnp.concatenate([x1, x2, x1 * x1, x2 * x2, x1 * x2], axis=0)
        blurred = _blur_window_masked(stacked, pvh, pvw)
        mu1, mu2 = blurred[:n], blurred[n : 2 * n]
        s11, s22, s12 = (
            blurred[2 * n : 3 * n],
            blurred[3 * n : 4 * n],
            blurred[4 * n :],
        )
        mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        ssim_map = ((2.0 * mu12 + D_C1) * (2.0 * (s12 - mu12) + D_C2)) / (
            (mu11 + mu22 + D_C1) * ((s11 - mu11) + (s22 - mu22) + D_C2)
        )
        return jnp.sum(ssim_map * mask[None], axis=(1, 2)) / count

    luma1, luma2 = lab1[:1], lab2[:1]
    chroma1, _, _ = _downscale_masked(lab1[1:], vh, vw)
    chroma2, cvh, cvw = _downscale_masked(lab2[1:], vh, vw)
    total = jnp.asarray(0.0, dtype=lab1.dtype)
    wsum = 0.0
    for scale, sweight in enumerate(SCALE_WEIGHTS):
        if scale:
            luma1, _, _ = _downscale_masked(luma1, vh, vw)
            luma2, vh, vw = _downscale_masked(luma2, vh, vw)
            chroma1, _, _ = _downscale_masked(chroma1, cvh, cvw)
            chroma2, cvh, cvw = _downscale_masked(chroma2, cvh, cvw)
        total = total + sweight * ssim_means_masked(luma1, luma2, vh, vw)[0]
        total = total + sweight * CHROMA_WEIGHT * jnp.sum(
            ssim_means_masked(chroma1, chroma2, cvh, cvw)
        )
        wsum += sweight * (1.0 + 2.0 * CHROMA_WEIGHT)
    ssim = jnp.clip(total / wsum, 1e-6, 1.0)
    val = 1.0 / ssim - 1.0
    identical = jnp.all(ref_pad_u8 == dist_pad_u8)
    return jnp.where(identical, jnp.asarray(0.0, val.dtype), val)


def butteraugli_masked(
    ref_pad_u8: jnp.ndarray,
    dist_pad_u8: jnp.ndarray,
    valid_h: jnp.ndarray,
    valid_w: jnp.ndarray,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> jnp.ndarray:
    """Butteraugli (max-norm) of a zero-padded pair; jittable, dims dynamic.

    The faithful pipeline (kernels/butteraugli.py) is mask-aware end to end:
    every blur renormalizes over the valid rectangle only (masked
    banded-Toeplitz operators), the Malta diffs and FuzzyErosion exclude
    out-of-valid samples, and the half-resolution pass applies the same
    odd-dim downscale correction as the SSIMULACRA2 masked pyramid.  The
    final max-norm is taken over valid pixels only.
    """
    from .butteraugli import (
        ButteraugliParams,
        _add_supersampled2x,
        _diffmap_psycho,
        _opsin_dynamics,
        _separate_frequencies,
    )

    params = ButteraugliParams(
        hf_asymmetry=hf_asymmetry, intensity_target=intensity_target
    )
    h, w = ref_pad_u8.shape[0], ref_pad_u8.shape[1]
    vh = jnp.minimum(jnp.asarray(valid_h, jnp.int32), h)
    vw = jnp.minimum(jnp.asarray(valid_w, jnp.int32), w)

    it = jnp.float32(intensity_target)
    lin1 = jnp.moveaxis(srgb_u8_to_linear(ref_pad_u8), -1, 0)
    lin2 = jnp.moveaxis(srgb_u8_to_linear(dist_pad_u8), -1, 0)

    def masked_scale(l1, l2, cvh, cvw):
        hh, ww = l1.shape[-2], l1.shape[-1]
        mrow = (jnp.arange(hh) < cvh).astype(jnp.float32)
        mcol = (jnp.arange(ww) < cvw).astype(jnp.float32)
        m2 = mrow[:, None] * mcol[None, :]
        b1 = _separate_frequencies(
            _opsin_dynamics(l1 * it, m2, mrow, mcol), m2, mrow, mcol
        )
        b2 = _separate_frequencies(
            _opsin_dynamics(l2 * it, m2, mrow, mcol), m2, mrow, mcol
        )
        dmap = _diffmap_psycho(
            b1, b2, hf_asymmetry, params.xmul, mask2d=m2, mrow=mrow, mcol=mcol
        )
        return dmap, m2

    dmap, m2 = masked_scale(lin1, lin2, vh, vw)
    # Half-resolution pass (bucket dims are even; valid dims ceil(v/2) with
    # the odd-dim available-sample correction).
    s1, svh, svw = _downscale_masked(lin1, vh, vw)
    s2, _, _ = _downscale_masked(lin2, vh, vw)
    sub_dmap, _ = masked_scale(s1, s2, svh, svw)
    blended = _add_supersampled2x(dmap, sub_dmap)
    # The exact-shape kernel only adds the sub-scale when ceil(v/2) >= 8.
    dmap = jnp.where((svh >= 8) & (svw >= 8), blended, dmap)

    score = jnp.max(dmap * m2)
    score = jnp.where((vh >= 8) & (vw >= 8), score, 0.0)
    identical = jnp.all(ref_pad_u8 == dist_pad_u8)
    return jnp.where(identical, jnp.asarray(0.0, score.dtype), score)


def psnr_masked(
    ref_pad_u8: jnp.ndarray,
    dist_pad_u8: jnp.ndarray,
    valid_h: jnp.ndarray,
    valid_w: jnp.ndarray,
) -> jnp.ndarray:
    """PSNR (dB, 255 peak) over the valid region only."""
    h, w = ref_pad_u8.shape[0], ref_pad_u8.shape[1]
    vh = jnp.minimum(jnp.asarray(valid_h, jnp.int32), h)
    vw = jnp.minimum(jnp.asarray(valid_w, jnp.int32), w)
    mask = _valid_mask(h, w, vh, vw)[..., None]
    diff = ref_pad_u8.astype(jnp.float32) - dist_pad_u8.astype(jnp.float32)
    count = (vh * vw * 3).astype(jnp.float32)
    mse = jnp.sum(diff * diff * mask) / count
    return jnp.where(
        mse == 0.0,
        jnp.asarray(jnp.inf, jnp.float32),
        10.0 * jnp.log10(255.0 * 255.0 / jnp.maximum(mse, 1e-20)),
    )


def ssimulacra2_masked_batch(
    refs_pad: jnp.ndarray,
    dists_pad: jnp.ndarray,
    valid_hw: jnp.ndarray,
) -> jnp.ndarray:
    """Batch of padded pairs (N, H_pad, W_pad, 3) + (N, 2) valid dims."""
    return jax.vmap(
        lambda r, d, hw: ssimulacra2_masked(r, d, hw[0], hw[1])
    )(refs_pad, dists_pad, valid_hw)


def bucket_shapes(
    shapes: Sequence[Tuple[int, int]], granularity: int = 128
) -> List[Tuple[int, int]]:
    """Assign each (h, w) to a padded bucket shape (multiples of
    ``granularity``).  Coarse granularity trades padding waste for fewer
    compiled programs; 128 keeps five pyramid halvings even (any
    multiple of 32 does)."""
    g = granularity
    if g % 32:
        raise ValueError("granularity must be a multiple of 32")
    return [(-(-h // g) * g, -(-w // g) * g) for h, w in shapes]


def _bucketed_chunks(pairs, granularity: int, batch: int):
    """Group mixed-size pairs into padded shape buckets and yield padded
    chunk batches: (chunk_indices, refs, dists, valid_hw).  Short tails of
    a multi-chunk bucket are padded to ``batch`` (repeating the last pair)
    so the bucket stays on one compiled program."""
    assignments = bucket_shapes([p[0].shape[:2] for p in pairs], granularity)
    groups: dict = {}
    for i, shape in enumerate(assignments):
        groups.setdefault(shape, []).append(i)
    for (hp, wp), idxs in groups.items():
        for start in range(0, len(idxs), batch):
            chunk = idxs[start : start + batch]
            n = len(chunk)
            pad_n = batch if n < batch and len(idxs) > batch else n
            refs = np.stack(
                [pad_to_bucket(pairs[i][0], hp, wp) for i in chunk]
                + [pad_to_bucket(pairs[chunk[-1]][0], hp, wp)] * (pad_n - n)
            )
            dists = np.stack(
                [pad_to_bucket(pairs[i][1], hp, wp) for i in chunk]
                + [pad_to_bucket(pairs[chunk[-1]][1], hp, wp)] * (pad_n - n)
            )
            hw = np.array(
                [pairs[i][0].shape[:2] for i in chunk]
                + [pairs[chunk[-1]][0].shape[:2]] * (pad_n - n),
                np.int32,
            )
            yield chunk, refs, dists, hw


def score_mixed_sizes(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    granularity: int = 128,
    batch: int = 8,
) -> np.ndarray:
    """SSIMULACRA2 for mixed-size uint8 pairs with bucketed masked scoring.

    Groups pairs into padded shape buckets and scores each bucket with one
    compiled program regardless of the exact sizes inside it.  Returns
    scores in input order.
    """
    if not pairs:
        return np.zeros((0,), np.float32)
    fn = jax.jit(ssimulacra2_masked_batch)
    out = np.zeros(len(pairs), np.float32)
    for chunk, refs, dists, hw in _bucketed_chunks(pairs, granularity, batch):
        scores = np.asarray(fn(refs, dists, hw))
        for j, i in enumerate(chunk):
            out[i] = scores[j]
    return out


def _fused_masked_all(refs_pad, dists_pad, valid_hw):
    """All four masked metrics for a batch of padded pairs, one XLA program."""

    def one(r, d, hw):
        return {
            "ssimulacra2": ssimulacra2_masked(r, d, hw[0], hw[1]),
            "dssim": dssim_masked(r, d, hw[0], hw[1]),
            "butteraugli": butteraugli_masked(r, d, hw[0], hw[1]),
            "psnr": psnr_masked(r, d, hw[0], hw[1]),
        }

    return jax.vmap(one)(refs_pad, dists_pad, valid_hw)


def score_mixed_sizes_all(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    granularity: int = 128,
    batch: int = 8,
) -> dict:
    """All four metrics for mixed-size uint8 pairs with bucketed masked
    scoring: one fused compiled program per padded shape bucket.  Returns
    ``{metric: np.ndarray}`` in input order."""
    keys = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    if not pairs:
        return {k: np.zeros((0,), np.float32) for k in keys}
    fn = jax.jit(_fused_masked_all)
    out = {k: np.zeros(len(pairs), np.float32) for k in keys}
    for chunk, refs, dists, hw in _bucketed_chunks(pairs, granularity, batch):
        scores = {k: np.asarray(v) for k, v in fn(refs, dists, hw).items()}
        for j, i in enumerate(chunk):
            for k in keys:
                out[k][i] = scores[k][j]
    return out


__all__ = [
    "pad_to_bucket",
    "ssimulacra2_masked",
    "ssimulacra2_masked_batch",
    "dssim_masked",
    "butteraugli_masked",
    "psnr_masked",
    "bucket_shapes",
    "score_mixed_sizes",
    "score_mixed_sizes_all",
]
