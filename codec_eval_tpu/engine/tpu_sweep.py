"""Device-resident R-D sweep: encode, decode, and score a whole tpujpeg
quality ladder without candidate pixels ever leaving the device.

This is the capability the reference cannot have: its eval loop round-trips
every (codec, quality) candidate through host RAM between the codec and the
scorer (reference: crates/codec-iter/src/eval.rs:151-167 encode -> decode ->
compare per pair; the CUDA path still uploads each decoded frame,
crates/codec-iter/src/gpu.rs:83-109).  Here the tpujpeg transform, the
per-quality quantize/dequantize/iDCT reconstruction
(kernels/jpeg_enc.build_reconstruct_sweep), and the fused all-metric scorer
(engine/scoring) compose on device: per image, two dispatches produce the
full ladder's scores.  The only host work is the optional entropy-coding
pass that turns the (already device-computed) quantized coefficients into
real .jpg bytes for exact file sizes — and it overlaps with the next
image's device work.

The scored pixels are this framework's own decoder output; a libjpeg decode
of the emitted bytes differs by ~0.6 u8 RMS (integer iDCT vs float), which
moves SSIMULACRA2 by well under a point (pinned in tests/test_tpujpeg.py).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kernels import jpeg_enc as _je
from ..utils import native as _native

__all__ = ["TpuSweepPoint", "evaluate_tpujpeg_sweep", "encode_to_target"]


@dataclass
class TpuSweepPoint:
    """One (quality) row of a device-resident ladder evaluation."""

    quality: float
    bits_per_pixel: Optional[float]
    file_size: Optional[int]
    metrics: Dict[str, float]
    data: Optional[bytes] = None  # the .jpg bytes, when return_bytes=True


def _qtabs_for(
    qualities: Sequence[float], colorspace: str = "ycbcr"
) -> np.ndarray:
    if colorspace == "xyb":
        bases = (_je.XYB_LUMA_BASE, _je.XYB_CHROMA_BASE)
    else:
        bases = (_je.ANNEX_K_LUMA, _je.ANNEX_K_CHROMA)
    return np.stack(
        [
            np.stack(_je.quality_to_qtables(q, *bases)).astype(np.float32)
            for q in qualities
        ]
    )  # (n_q, 2, 64) natural order


def evaluate_tpujpeg_sweep(
    image_u8: np.ndarray,
    qualities: Sequence[float],
    subsampling: str = "420",
    aq_strength: float = 0.30,
    metrics: Sequence[str] = ("dssim", "ssimulacra2", "butteraugli", "psnr"),
    with_sizes: "bool | str" = True,
    size_pool: Optional[ThreadPoolExecutor] = None,
    colorspace: str = "ycbcr",
    progressive: bool = False,
    return_bytes: bool = False,
    trellis_lambda: float = 0.0,
) -> List[TpuSweepPoint]:
    """Score a full tpujpeg quality ladder for one image on device.

    with_sizes=False skips the host entropy pass entirely (scores only —
    useful when hunting a quality threshold rather than an R-D curve).
    with_sizes="device" computes file sizes from device-side rate
    statistics (kernels/jpeg_rate.py): only packed symbol counts per
    quality leave the device instead of the full coefficient planes —
    entropy-exact, 0xFF stuffing estimated (~±0.15% of size), for both
    baseline and progressive scan scripts.  with_sizes=True entropy-codes
    on host for exact bytes.  return_bytes=True additionally keeps each
    quality's .jpg bytes (implies the host entropy pass).
    trellis_lambda > 0 runs the trellis DP on device
    (kernels/jpeg_enc.trellis_quantize_dev) in place of the AQ rounding
    bias.
    """
    size_mode = {True: "exact", False: "none"}.get(with_sizes, with_sizes)
    if size_mode not in ("exact", "none", "device"):
        raise ValueError(f"with_sizes must be bool or 'device', got {with_sizes!r}")
    if return_bytes:
        size_mode = "exact"
    with_sizes = size_mode != "none"
    import jax.numpy as jnp

    from .scoring import _build_chunk_scorer, _build_precompute

    h, w = image_u8.shape[:2]
    n_q = len(qualities)
    want = {m: m in metrics for m in ("dssim", "ssimulacra2", "butteraugli", "psnr")}

    if colorspace == "xyb":
        subsampling = "444"
    # Planar candidates + the planar scorer variant (the layout every
    # metric consumes), and the coefficient outputs are dropped
    # from the program entirely when no byte sizes are needed.
    recon = _je.build_reconstruct_sweep(
        h, w, n_q, subsampling, colorspace,
        planar_candidates=True, with_coefs=with_sizes,
        trellis_lambda=float(trellis_lambda),
    )
    pre_fn = _build_precompute(
        h, w, want["dssim"], want["ssimulacra2"], want["butteraugli"], False
    )
    scorer = _build_chunk_scorer(
        h, w, n_q,
        want["dssim"], want["ssimulacra2"], want["butteraugli"], want["psnr"],
        planar=True,
    )

    img_dev = jnp.asarray(image_u8)
    qtabs = jnp.asarray(_qtabs_for(qualities, colorspace))
    cands, coefs = recon(img_dev, qtabs, float(aq_strength))
    scores = scorer(pre_fn(img_dev), cands)

    sizes: List[Optional[int]] = [None] * n_q
    blobs: List[Optional[bytes]] = [None] * n_q
    if size_mode == "device":
        from ..kernels import jpeg_rate as _jr

        app_mode = 1 if colorspace == "xyb" else 0
        if progressive:
            stats_fn = _jr.build_progressive_ladder_rate_stats(
                h, w, subsampling
            )
            st = stats_fn(coefs["y"], coefs["cb"], coefs["cr"])
            sizes = _jr.progressive_size_estimates_from_packed(
                st, app_mode=app_mode
            )
        else:
            stats_fn = _jr.build_ladder_rate_stats(subsampling)
            st = stats_fn(coefs["y"], coefs["cb"], coefs["cr"])
            sizes = _jr.size_estimates_from_packed(st, app_mode=app_mode)
    elif with_sizes:
        # Entropy-code on host for exact bytes; the coefficient fetch and
        # the Huffman pass overlap device scoring via the thread pool.
        cy = np.asarray(coefs["y"])
        ccb = np.asarray(coefs["cb"])
        ccr = np.asarray(coefs["cr"])
        host_qtabs = _qtabs_for(qualities, colorspace)

        def encode_of(qi: int) -> bytes:
            ql = host_qtabs[qi, 0].astype(np.uint16)
            qc = host_qtabs[qi, 1].astype(np.uint16)
            return _native.jpeg_encode_baseline(
                w, h, subsampling,
                cy[qi], ccb[qi], ccr[qi],
                ql[_je.ZIGZAG], qc[_je.ZIGZAG],
                app_mode=1 if colorspace == "xyb" else 0,
                progressive=progressive,
            )

        if size_pool is not None:
            datas = list(size_pool.map(encode_of, range(n_q)))
        else:
            datas = [encode_of(qi) for qi in range(n_q)]
        sizes = [len(d) for d in datas]
        if return_bytes:
            blobs = list(datas)

    from .scoring import fetch_scores

    host_scores = fetch_scores(scores)
    points = []
    for qi, q in enumerate(qualities):
        row = {k: float(v[qi]) for k, v in host_scores.items()}
        points.append(
            TpuSweepPoint(
                quality=float(q),
                bits_per_pixel=(
                    sizes[qi] * 8.0 / (h * w) if sizes[qi] is not None else None
                ),
                file_size=sizes[qi],
                metrics=row,
                data=blobs[qi],
            )
        )
    return points


def encode_to_target(
    image_u8: np.ndarray,
    min_ssimulacra2: Optional[float] = None,
    max_butteraugli: Optional[float] = None,
    max_dssim: Optional[float] = None,
    max_bits_per_pixel: Optional[float] = None,
    qualities: Sequence[float] = tuple(range(30, 99, 2)),
    subsampling: str = "420",
    aq_strength: float = 0.30,
    colorspace: str = "ycbcr",
    progressive: bool = False,
    trellis_lambda: float = 0.0,
) -> TpuSweepPoint:
    """Encode to a perceptual (and/or rate) target: the smallest file on
    the quality grid satisfying every given constraint.

    The whole dense grid is evaluated as ONE device ladder (scores only —
    plus device rate statistics when a bpp ceiling is requested), then the
    single selected quality is entropy-coded on host for the real bytes.
    This is the capability the device-resident architecture buys: a
    distance-targeted encode (cjxl-style) costs one dispatch instead of a
    host-side encode/decode/score search loop — the reference's analog is
    assert_quality-driven manual iteration
    (src/eval/helpers.rs:212-253, crates/codec-iter eval loops).

    Raises QualityBelowThreshold if no grid point satisfies the
    constraints.  Returns a TpuSweepPoint with `.data` (the .jpg bytes),
    exact `file_size`/`bits_per_pixel`, and the device-scored metrics of
    the chosen quality.
    """
    from ..errors import QualityBelowThreshold

    if not any(
        c is not None
        for c in (min_ssimulacra2, max_butteraugli, max_dssim,
                  max_bits_per_pixel)
    ):
        raise ValueError("no target given")
    metrics = tuple(
        m
        for m, need in (
            ("ssimulacra2", min_ssimulacra2 is not None),
            ("butteraugli", max_butteraugli is not None),
            ("dssim", max_dssim is not None),
        )
        if need
    ) or ("ssimulacra2",)
    qualities = sorted(float(q) for q in qualities)
    points = evaluate_tpujpeg_sweep(
        image_u8,
        qualities,
        subsampling=subsampling,
        aq_strength=aq_strength,
        metrics=metrics,
        with_sizes="device" if max_bits_per_pixel is not None else False,
        colorspace=colorspace,
        progressive=progressive,
        trellis_lambda=trellis_lambda,
    )

    def ok_perceptual(p: TpuSweepPoint) -> bool:
        if min_ssimulacra2 is not None and p.metrics["ssimulacra2"] < min_ssimulacra2:
            return False
        if max_butteraugli is not None and p.metrics["butteraugli"] > max_butteraugli:
            return False
        if max_dssim is not None and p.metrics["dssim"] > max_dssim:
            return False
        return True

    # Quality is the rate knob: the lowest admissible grid point is the
    # smallest file.  (Scores are not perfectly monotone in q, so scan
    # rather than bisect — the grid is already scored.)  Device byte sizes
    # are estimates (±0.15%, pinned ±0.4%): admit bpp-marginal points here
    # and settle against the exact entropy-coded size below.
    _BPP_EST_MARGIN = 1.004
    chosen = next(
        (
            p
            for p in points
            if ok_perceptual(p)
            and (
                max_bits_per_pixel is None
                or p.bits_per_pixel <= max_bits_per_pixel * _BPP_EST_MARGIN
            )
        ),
        None,
    )
    if chosen is None:
        # Name the constraint that actually binds.  The highest quality's
        # scores are the best the grid can do: a perceptual floor it still
        # misses is infeasible outright; otherwise the floors are reachable
        # and the bpp ceiling is what excludes every admissible point.
        top = points[-1]
        if min_ssimulacra2 is not None and top.metrics["ssimulacra2"] < min_ssimulacra2:
            raise QualityBelowThreshold(
                "SSIMULACRA2", top.metrics["ssimulacra2"], min_ssimulacra2
            )
        if max_butteraugli is not None and top.metrics["butteraugli"] > max_butteraugli:
            raise QualityBelowThreshold(
                "Butteraugli", top.metrics["butteraugli"], max_butteraugli
            )
        if max_dssim is not None and top.metrics["dssim"] > max_dssim:
            raise QualityBelowThreshold(
                "DSSIM", top.metrics["dssim"], max_dssim
            )
        admissible = [p for p in points if ok_perceptual(p)] or points
        raise QualityBelowThreshold(
            "bits_per_pixel",
            min(p.bits_per_pixel for p in admissible),
            max_bits_per_pixel,
        )

    # Exact bytes for the one selected quality.
    exact = evaluate_tpujpeg_sweep(
        image_u8,
        [chosen.quality],
        subsampling=subsampling,
        aq_strength=aq_strength,
        metrics=metrics,
        with_sizes=True,
        colorspace=colorspace,
        progressive=progressive,
        return_bytes=True,
        trellis_lambda=trellis_lambda,
    )[0]
    # Settle the rate cap against the exact size.  Exact sizes grow with
    # quality, so if the smallest admissible point busts the ceiling every
    # higher point does too — the cap is genuinely infeasible on this grid.
    if max_bits_per_pixel is not None and exact.bits_per_pixel > max_bits_per_pixel:
        raise QualityBelowThreshold(
            "bits_per_pixel", exact.bits_per_pixel, max_bits_per_pixel
        )
    # Keep the already-computed grid scores (identical program) but the
    # exact size/bytes.
    return TpuSweepPoint(
        quality=chosen.quality,
        bits_per_pixel=exact.bits_per_pixel,
        file_size=exact.file_size,
        metrics=exact.metrics,
        data=exact.data,
    )
