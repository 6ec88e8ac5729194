"""Device-side JPEG decoding: host Huffman parse + accelerator reconstruction.

The reference decodes every candidate entirely on host (jpeg-decoder in
src/decode.rs:41-98; each codec adapter's decode_fn) and so does this
framework's conventional callback path (PIL).  This module splits the
decode at the natural boundary instead: the host runs only the entropy
decode (native/jpeg_huff_decode.cpp — baseline and progressive, ~3-5x
cheaper than a full libjpeg decode), and dequantization + inverse DCT +
fancy chroma upsampling run on the device as one jitted program
(kernels/jpeg_enc.build_jpeg_decode).  For scoring pipelines this keeps
decoded pixels device-resident: `decode_jpeg_to_device` hands back the
planar (3, H, W) u8 array the chunk scorer consumes directly, and
`score_jpeg_files` scores a list of same-shape .jpg candidates against a
reference without any decoded pixels visiting host RAM.

Supported envelope: 8-bit Huffman JPEG, 3-component (chroma sampling
4:4:4 / 4:2:0 / 4:2:2 / 4:4:0) or 1-component grayscale (4:0:0, luma
replicated to RGB), baseline SOF0/SOF1 and progressive SOF2 with spectral
selection + successive approximation, restart markers, JFIF or Adobe
APP14 containers (transform 0 = passthrough: the tpujpeg XYB opsin
container decodes through the same path).  Everything else raises
UnsupportedFormat — callers fall back to their host decoder.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import native as _native

__all__ = [
    "is_available",
    "parse_jpeg",
    "decode_jpeg_device",
    "decode_jpeg_to_device",
    "score_jpeg_files",
]


def is_available() -> bool:
    lib = _native._load()
    return lib is not None and hasattr(lib, "ce_jpeg_parse")


def parse_jpeg(data: bytes) -> dict:
    """Host half: entropy-decode to quantized zigzag coefficient planes.
    See utils.native.jpeg_parse_coefficients for the returned fields."""
    return _native.jpeg_parse_coefficients(data)


def _colorspace_of(parsed: dict) -> str:
    # Adobe transform 0 = channels pass through undecoded; tpujpeg writes
    # its XYB opsin container this way.  JFIF (no Adobe marker) and Adobe
    # transform 1 are YCbCr.
    return "xyb" if parsed["adobe_transform"] == 0 else "ycbcr"


def decode_jpeg_to_device(data: bytes, planar: bool = True):
    """Parse on host, reconstruct on device; returns the (3, H, W) —
    or (H, W, 3) with planar=False — u8 DEVICE array, unfetched."""
    from ..kernels.jpeg_enc import build_jpeg_decode

    p = parse_jpeg(data)
    fn = build_jpeg_decode(
        p["height"], p["width"], p["subsampling"], _colorspace_of(p),
        planar=planar,
    )
    return fn(
        p["y"], p["cb"], p["cr"], p["qtab_luma_zz"], p["qtab_chroma_zz"]
    )


def decode_jpeg_device(data: bytes) -> np.ndarray:
    """Full decode convenience: returns the (H, W, 3) u8 numpy array."""
    return np.asarray(decode_jpeg_to_device(data, planar=False))


def score_jpeg_files(
    ref_u8: np.ndarray,
    candidates: Sequence[bytes],
    metrics: Sequence[str] = ("dssim", "ssimulacra2", "butteraugli", "psnr"),
    parse_pool: Optional[ThreadPoolExecutor] = None,
) -> List[Dict[str, float]]:
    """Score same-shape .jpg candidates against one reference with
    device-resident decoding: per candidate the host contributes only the
    Huffman parse; reconstruction feeds the fused all-metric chunk scorer
    as one device batch (one program per distinct (shape, subsampling,
    colorspace) group; candidates may mix configurations).

    Returns one {metric: score} dict per candidate, input order.
    """
    import jax.numpy as jnp

    from ..engine.scoring import (
        _build_chunk_scorer,
        _build_precompute,
        fetch_scores,
    )
    from ..kernels.jpeg_enc import build_jpeg_decode

    h, w = ref_u8.shape[:2]
    want = {
        m: m in metrics
        for m in ("dssim", "ssimulacra2", "butteraugli", "psnr")
    }
    parsed = (
        list(parse_pool.map(parse_jpeg, candidates))
        if parse_pool is not None
        else [parse_jpeg(d) for d in candidates]
    )
    for p in parsed:
        if (p["height"], p["width"]) != (h, w):
            from ..errors import DimensionMismatch

            raise DimensionMismatch((w, h), (p["width"], p["height"]))

    # Group by decode configuration so each group decodes as one vmapped
    # program and scores as one chunk.
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(parsed):
        groups.setdefault(
            (p["subsampling"], _colorspace_of(p), p["y"].shape[:2]), []
        ).append(i)

    pre = _build_precompute(
        h, w, want["dssim"], want["ssimulacra2"], want["butteraugli"], False
    )(jnp.asarray(ref_u8))

    out: List[Optional[Dict[str, float]]] = [None] * len(parsed)
    for (sub, cspace, _shape), idxs in groups.items():
        # Per-candidate decode dispatches, stacked on device: the async
        # dispatch stream pipelines each candidate's coefficient transfer
        # with the previous one's decode, which measures ~2x faster here
        # than one stacked transfer + one vmapped dispatch
        # (build_jpeg_decode(batch=True) exists for PCIe-local hosts where
        # a single large transfer wins instead).
        dec = build_jpeg_decode(h, w, sub, cspace, planar=True)
        batch = jnp.stack(
            [
                dec(
                    parsed[i]["y"], parsed[i]["cb"], parsed[i]["cr"],
                    parsed[i]["qtab_luma_zz"], parsed[i]["qtab_chroma_zz"],
                )
                for i in idxs
            ]
        )
        scorer = _build_chunk_scorer(
            h, w, len(idxs),
            want["dssim"], want["ssimulacra2"], want["butteraugli"],
            want["psnr"], planar=True,
        )
        scores = fetch_scores(scorer(pre, batch))
        for j, i in enumerate(idxs):
            out[i] = {k: float(v[j]) for k, v in scores.items()}
    return out  # type: ignore[return-value]
