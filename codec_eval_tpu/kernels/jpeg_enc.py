"""Device-side JPEG analysis/transform path for the tpujpeg encoder.

The reference fills its "jpegli-style pure-software encoder" slot with the
zenjpeg crate (reference: crates/codec-compare/src/encoders/zenjpeg.rs:10-58,
crates/codec-iter/src/config.rs:5-67).  This module is the accelerator analog
of that encoder's *analysis half*: everything quality-independent — color
conversion, chroma subsampling, the 8x8 forward DCTs (two matmuls per
block axis), and the per-block psychovisual activity field used for adaptive
rounding — runs as ONE jitted program per image.  The host then quantizes
the returned coefficient planes per quality (cheap elementwise numpy) and
entropy-codes with the native C++ Huffman coder
(native/jpeg_entropy.cpp via utils/native.py), mirroring the split the
reference makes between its Rust DCT path and its bit writer.

Why this split: a quality sweep (the dense-sweep workload, BASELINE.md)
re-encodes the same image at 25 qualities; the DCT and the activity field
are quality-invariant, so the device computes them once and the per-quality
work collapses to a rounding pass + Huffman.  The DCT itself is a pair of
(8,8) matmul contractions applied to every block — batched over all blocks
of the image, which XLA hands to its matrix kernels.

All math is f32 with HIGHEST matmul precision: quantized coefficients must
be exact integers, and reduced-precision (bf16/TF32) matmul rounding
would perturb round() decisions
near .5 boundaries (same pitfall as the opsin matmul fix documented in
ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "ZIGZAG",
    "ac_code_lengths",
    "ac_symbol_histogram",
    "dct8_matrix",
    "huffman_code_lengths",
    "jpeg_transform",
    "build_transform",
    "quantize_blocks",
    "quality_to_qtables",
    "trellis_quantize_blocks",
    "trellis_quantize_dev",
]

#: Natural-order index of each coefficient in zigzag scan order
#: (identical to libjpeg's jpeg_natural_order; ITU T.81 Figure 5).
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

#: ITU T.81 Annex K.1 example quantization tables (natural row-major order).
#: These are the interoperability baseline every JPEG encoder scales from;
#: the psychovisually retuned tables live in codecs/tpujpeg.py.
ANNEX_K_LUMA = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.float64,
)

ANNEX_K_CHROMA = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.float64,
)


#: Base quantization tables for the XYB colorspace mode (channel order
#: Y, X, B-Y after the [0,255] range scaling).  XYB is already perceptually
#: uniformized by the opsin cube root, so the CSF slope baked into Annex K
#: over-quantizes XYB high frequencies; these use a flattened profile
#: (sqrt of Annex-K luma, rescaled to the same DC step).  The X/(B-Y)
#: table is the same shape scaled up 1.6x.  Selected by BD-rate scan
#: (2026-08-18, SSIMULACRA2 vs PIL 4:4:4 optimized, 512px): this pairing
#: measured -27% on the noisy corpus and +3.8% on the clean corpus — the
#: best clean-corpus candidate (finer variants reached -34% noisy but
#: +13..+41% clean).  Two structural notes: storing B decorrelated as B-Y
#: was worth ~55 BD-rate points on clean content (raw B double-quantizes
#: luminance), and the residual clean-corpus gap vs YCbCr is the 8-bit
#: baseline container's floor-level precision, which jpegli proper works
#: around with decoder-side machinery a standard JPEG decoder lacks.
XYB_LUMA_BASE = np.clip(
    np.sqrt(ANNEX_K_LUMA) * 4.0, 1.0, 255.0
).astype(np.float64)
XYB_CHROMA_BASE = np.clip(XYB_LUMA_BASE * 1.6, 1.0, 255.0).astype(np.float64)

#: [0,255] scaling ranges for the XYB-mode channels in bitstream order
#: (Y, X, B-Y).  Y/X are the empirical sRGB opsin ranges (xyb.rs:185-190);
#: B-Y was measured over the sRGB cube (52^3 grid): [-0.278, 0.388],
#: padded.  B is stored decorrelated (B-Y), matching jpegli's layout.
XYB_ENC_RANGES = np.array(
    [[0.0, 0.846], [-0.016, 0.029], [-0.29, 0.40]], dtype=np.float32
)

#: Default (16, 11) AC (run, size) bit-length models for the trellis rate
#: term: optimized-Huffman fits to pooled round-to-nearest statistics
#: (4 clean 512px images x q in {50, 70, 85, 95}; regenerate with
#: tools/fit_rate_tables.py).  The trellis is insensitive to the fit:
#: per-image fitted tables measured 0.01 BD-rate points better than these
#: in YCbCr (-24.09% vs -24.08%) and 0.07 in XYB (-45.17% vs -45.10%),
#: so one static table set serves both colorspaces — which is what lets
#: the device-resident ladder run the DP with no host round trip.
#: Unseen symbols carry the 16-bit default; entries >16 are unlimited-
#: depth Huffman estimates (a rate model, not emitted code lengths).
DEFAULT_AC_LENGTHS_LUMA = np.array(
    [
        [3, 2, 3, 3, 4, 4, 5, 6, 12, 16, 16],
        [16, 4, 5, 7, 8, 10, 12, 14, 16, 16, 16],
        [16, 5, 7, 8, 11, 15, 19, 16, 16, 16, 16],
        [16, 6, 9, 11, 15, 16, 16, 16, 16, 16, 16],
        [16, 7, 10, 14, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 12, 15, 15, 16, 16, 16, 16, 16, 16],
        [16, 7, 13, 14, 19, 16, 16, 16, 16, 16, 16],
        [16, 10, 14, 15, 19, 16, 16, 16, 16, 16, 16],
        [16, 10, 15, 19, 16, 16, 16, 16, 16, 16, 16],
        [16, 8, 13, 18, 16, 16, 16, 16, 16, 16, 16],
        [16, 9, 14, 17, 18, 16, 16, 16, 16, 16, 16],
        [16, 11, 14, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 12, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 12, 14, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 13, 17, 16, 16, 16, 16, 16, 16, 16, 16],
        [13, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16],
    ],
    dtype=np.float32,
)

DEFAULT_AC_LENGTHS_CHROMA = np.array(
    [
        [2, 2, 2, 4, 9, 16, 16, 16, 16, 16, 16],
        [16, 3, 6, 8, 14, 16, 16, 16, 16, 16, 16],
        [16, 6, 9, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 13, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 9, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 10, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 11, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 13, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 14, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
    ],
    dtype=np.float32,
)


def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix C with C[u, x] = s(u) cos((2x+1)u pi/16).

    F = C f C^T reproduces the JPEG forward DCT (T.81 A.3.3) exactly:
    s(0) = sqrt(1/8) and s(u>0) = 1/2 give the 1/4 C(u) C(v) normalization.
    """
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    c = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    c[0, :] *= np.sqrt(0.5)
    return (c * 0.5).astype(np.float32)


def quality_to_qtables(
    quality: float,
    base_luma: np.ndarray = ANNEX_K_LUMA,
    base_chroma: np.ndarray = ANNEX_K_CHROMA,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale base tables by the libjpeg quality convention (jcparam.c's
    jpeg_quality_scaling): scale = 5000/q below 50 else 200 - 2q.

    Returns uint16 natural-order tables clamped to [1, 255] (baseline JPEG
    requires 8-bit table entries).
    """
    q = float(min(max(quality, 1.0), 100.0))
    scale = 5000.0 / q if q < 50.0 else 200.0 - 2.0 * q

    def scaled(base: np.ndarray) -> np.ndarray:
        t = np.floor((base * scale + 50.0) / 100.0)
        return np.clip(t, 1.0, 255.0).astype(np.uint16)

    return scaled(np.asarray(base_luma)), scaled(np.asarray(base_chroma))


@functools.lru_cache(maxsize=1)
def _zigzag_dct_matrix() -> np.ndarray:
    """The fused (2D DCT + zigzag) operator as one orthonormal 64x64 matrix.

    W[k, x*8+y] = C[u_k, x] * C[v_k, y], where (u_k, v_k) is the natural
    position of zigzag index k.  Then for a row-major flattened block f:
      forward:  F_zz = f_flat @ W.T
      inverse:  f_flat = F_zz @ W          (rows of W are orthonormal)
    One (n_blocks, 64) @ (64, 64) contraction per plane instead of two
    8-point einsums plus a 64-way gather — the gather (inverse zigzag) is
    the expensive part, and the matmul shape suits the matrix units.
    Computed in float64, applied in f32 at HIGHEST precision.
    """
    c = dct8_matrix().astype(np.float64)
    w = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        u, v = divmod(int(ZIGZAG[k]), 8)
        for x in range(8):
            for y in range(8):
                w[k, x * 8 + y] = c[u, x] * c[v, y]
    return w.astype(np.float32)


def _pad_edge_2d(plane: jnp.ndarray, mult: int) -> jnp.ndarray:
    h, w = plane.shape
    hp = -h % mult
    wp = -w % mult
    if hp or wp:
        plane = jnp.pad(plane, ((0, hp), (0, wp)), mode="edge")
    return plane


def _blockify(plane: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (by, bx, 8, 8); H, W already multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _dct_blocks(blocks: jnp.ndarray, cmat: jnp.ndarray) -> jnp.ndarray:
    """Forward DCT over (..., 8, 8) blocks: C f C^T as two contractions.

    HIGHEST precision: coefficient values feed integer rounding decisions,
    so a reduced-precision (bf16/TF32) matmul is not acceptable here.
    """
    t = jnp.einsum(
        "ux,...xy->...uy", cmat, blocks, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "vy,...uy->...uv", cmat, t, precision=jax.lax.Precision.HIGHEST
    )


def _activity_field(y_plane: jnp.ndarray) -> jnp.ndarray:
    """Per-block psychovisual activity in [0, 1] from the (padded) Y plane.

    Activity is the log-compressed intra-block AC energy: sqrt of the block
    variance of Y (0..255), mapped through log1p and normalized so flat
    gradients score ~0 and dense texture saturates toward 1.  The host maps
    this to a per-block rounding bias (deadzone width) — the standard-
    decodable form of jpegli-style adaptive quantization: the quantization
    *tables* stay global, only the rounding of masked blocks biases toward
    zero, spending fewer bits where HVS masking hides the loss.
    """
    blocks = _blockify(y_plane)
    mean = jnp.mean(blocks, axis=(-1, -2), keepdims=True)
    var = jnp.mean((blocks - mean) ** 2, axis=(-1, -2))
    sd = jnp.sqrt(var + 1e-6)
    # log1p(sd / 2): sd ~= 2 (near-invisible noise) -> 0.69; sd ~= 40
    # (strong texture) -> 3.0.  Normalize by log1p(40 / 2).
    act = jnp.log1p(sd * 0.5) / np.log1p(20.0)
    return jnp.clip(act, 0.0, 1.0)


@functools.lru_cache(maxsize=32)
def build_transform(
    height: int, width: int, subsampling: str = "420", colorspace: str = "ycbcr"
):
    """Jitted quality-independent JPEG analysis for one image shape.

    Returns a function rgb_u8 (H, W, 3) -> dict of
      dct_y   (byY, bxY, 64) f32 zigzag-order DCT coefficients
      dct_cb / dct_cr (byC, bxC, 64)
      act_y   (byY, bxY) activity in [0, 1]
      act_c   (byC, bxC) activity of the chroma block grid (from Y)
    Block grids are padded to full MCUs (16x16 luma pixels for 4:2:0,
    8x8 for 4:4:4) by edge replication, as the entropy coder requires.

    colorspace="xyb" (the jpegli-signature mode the reference's zenjpeg
    exposes, crates/codec-iter/src/config.rs:5-67): channels are the JPEG XL
    opsin XYB values scaled to [0, 255] by the empirical sRGB ranges
    (kernels/color.py XYB_RANGES), stored in (Y, X, B) order so the
    brightness-like channel takes the luma quantization table.  XYB
    requires 4:4:4 and the Adobe-transform-0 bitstream flavor (the decoder
    must not apply the YCbCr inverse).
    """
    if subsampling not in ("420", "444", "422", "440"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    if colorspace not in ("ycbcr", "xyb"):
        raise ValueError(f"unsupported colorspace {colorspace!r}")
    if colorspace == "xyb" and subsampling != "444":
        raise ValueError("xyb colorspace requires 4:4:4")
    wmat = jnp.asarray(_zigzag_dct_matrix())

    def transform(rgb_u8: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        if colorspace == "xyb":
            from .color import linear_rgb_to_xyb, srgb_u8_to_linear

            xyb = linear_rgb_to_xyb(srgb_u8_to_linear(rgb_u8))
            # (Y, X, B-Y): brightness first (luma table + activity source);
            # B is stored decorrelated from Y, as jpegli does — raw B
            # duplicates Y for neutrals, so quantizing it independently
            # would double-quantize luminance.
            y = (xyb[..., 1] - XYB_ENC_RANGES[0, 0]) / (
                XYB_ENC_RANGES[0, 1] - XYB_ENC_RANGES[0, 0]
            ) * 255.0
            cb = (xyb[..., 0] - XYB_ENC_RANGES[1, 0]) / (
                XYB_ENC_RANGES[1, 1] - XYB_ENC_RANGES[1, 0]
            ) * 255.0
            cr = (xyb[..., 2] - xyb[..., 1] - XYB_ENC_RANGES[2, 0]) / (
                XYB_ENC_RANGES[2, 1] - XYB_ENC_RANGES[2, 0]
            ) * 255.0
        else:
            rgb = rgb_u8.astype(jnp.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            # JFIF YCbCr (BT.601 full range), T.871 section 7.
            y = 0.299 * r + 0.587 * g + 0.114 * b
            cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
            cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

        sh = 2 if subsampling in ("420", "422") else 1
        sv = 2 if subsampling in ("420", "440") else 1

        def pad2(p):
            h0, w0 = p.shape
            hp = -h0 % (8 * sv)
            wp = -w0 % (8 * sh)
            if hp or wp:
                p = jnp.pad(p, ((0, hp), (0, wp)), mode="edge")
            return p

        y, cb, cr = pad2(y), pad2(cb), pad2(cr)
        if sh == 2 or sv == 2:
            # Box downsample along the subsampled axes (libjpeg h2v2/h2v1
            # convention, without the fancy smoothing pass).
            def down(p):
                if sv == 2:
                    p = 0.5 * (p[0::2, :] + p[1::2, :])
                if sh == 2:
                    p = 0.5 * (p[:, 0::2] + p[:, 1::2])
                return p

            cb, cr = down(cb), down(cr)

        def coeffs(plane):
            blocks = _blockify(plane - 128.0)
            flat = blocks.reshape(blocks.shape[0], blocks.shape[1], 64)
            return jnp.einsum(
                "kp,...p->...k", wmat, flat,
                precision=jax.lax.Precision.HIGHEST,
            )

        act_y = _activity_field(y)
        act_c = act_y
        if sv == 2:
            a = act_c.reshape(act_c.shape[0] // 2, 2, act_c.shape[1])
            act_c = jnp.max(a, axis=1)
        if sh == 2:
            a = act_c.reshape(act_c.shape[0], act_c.shape[1] // 2, 2)
            act_c = jnp.max(a, axis=2)
        return {
            "dct_y": coeffs(y),
            "dct_cb": coeffs(cb),
            "dct_cr": coeffs(cr),
            "act_y": act_y,
            "act_c": act_c,
        }

    return jax.jit(transform)


def jpeg_transform(
    rgb_u8: np.ndarray, subsampling: str = "420", colorspace: str = "ycbcr"
) -> Dict[str, np.ndarray]:
    """Host entry: run the device transform and fetch the planes."""
    h, w = rgb_u8.shape[:2]
    out = build_transform(h, w, subsampling, colorspace)(jnp.asarray(rgb_u8))
    return {k: np.asarray(v) for k, v in out.items()}


def _idct_blocks(coeffs: jnp.ndarray, cmat: jnp.ndarray) -> jnp.ndarray:
    """Inverse DCT over (..., 8, 8) blocks: C^T F C (C is orthonormal)."""
    t = jnp.einsum(
        "ux,...uv->...xv", cmat, coeffs, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "vy,...xv->...xy", cmat, t, precision=jax.lax.Precision.HIGHEST
    )


def _unblockify(blocks: jnp.ndarray) -> jnp.ndarray:
    """(by, bx, 8, 8) -> (by*8, bx*8)."""
    by, bx = blocks.shape[0], blocks.shape[1]
    return blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


@functools.lru_cache(maxsize=None)
def _triangle_up_matrix(n: int) -> np.ndarray:
    """(n, 2n) triangle-upsample operator: out[2i] = .75 in[i] + .25
    in[i-1], out[2i+1] = .75 in[i] + .25 in[i+1], edges clamped.  Applied
    as a matmul at HIGHEST precision, so the products keep f32 accuracy."""
    a = np.zeros((n, 2 * n), np.float32)
    i = np.arange(n)
    a[i, 2 * i] += 0.75
    a[np.maximum(i - 1, 0), 2 * i] += 0.25
    a[i, 2 * i + 1] += 0.75
    a[np.minimum(i + 1, n - 1), 2 * i + 1] += 0.25
    return a


def _triangle_up_h(plane: jnp.ndarray) -> jnp.ndarray:
    """2x triangle ("fancy") upsample along the width axis as a
    matmul against the sparse upsample operator (same trick as
    blur.pair_mean_matrix in the downscale direction)."""
    uw = jnp.asarray(_triangle_up_matrix(plane.shape[1]))  # (w, 2w)
    return jnp.einsum(
        "hw,wW->hW", plane, uw, precision=jax.lax.Precision.HIGHEST
    )


def _triangle_up_v(plane: jnp.ndarray) -> jnp.ndarray:
    """2x triangle upsample along the height axis (matmul form)."""
    uh = jnp.asarray(_triangle_up_matrix(plane.shape[0]))  # (h, 2h)
    return jnp.einsum(
        "hH,hW->HW", uh, plane, precision=jax.lax.Precision.HIGHEST
    )


def _triangle_upsample2x(plane: jnp.ndarray) -> jnp.ndarray:
    """Separable 2x2 triangle upsample with edge clamp — the libjpeg h2v2
    fancy-upsampling convention: out[2i] = (3 in[i] + in[i-1]) / 4,
    out[2i+1] = (3 in[i] + in[i+1]) / 4 per axis."""
    return _triangle_up_v(_triangle_up_h(plane))


def _scaled_xyb_to_rgb_u8(
    y: jnp.ndarray, x: jnp.ndarray, bmy: jnp.ndarray, planar: bool = False
) -> jnp.ndarray:
    """Invert the [0,255]-scaled (Y, X, B-Y) planes back to sRGB u8."""
    from .color import linear_to_srgb_u8, xyb_to_linear_rgb

    r = jnp.asarray(XYB_ENC_RANGES)
    yv = y / 255.0 * (r[0, 1] - r[0, 0]) + r[0, 0]
    xv = x / 255.0 * (r[1, 1] - r[1, 0]) + r[1, 0]
    bv = bmy / 255.0 * (r[2, 1] - r[2, 0]) + r[2, 0] + yv
    xyb = jnp.stack([xv, yv, bv], axis=-1)
    out = linear_to_srgb_u8(xyb_to_linear_rgb(xyb))
    return jnp.moveaxis(out, -1, 0) if planar else out


def _ycbcr_to_rgb_u8(
    y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray, planar: bool = False
) -> jnp.ndarray:
    """JFIF (BT.601 full-range) inverse color transform -> (H, W, 3) u8
    (or (3, H, W) with planar=True)."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    rgb = jnp.stack([r, g, b], axis=0 if planar else -1)
    return jnp.clip(jnp.round(rgb), 0.0, 255.0).astype(jnp.uint8)


@functools.lru_cache(maxsize=16)
def build_reconstruct_sweep(
    height: int,
    width: int,
    n_q: int,
    subsampling: str = "420",
    colorspace: str = "ycbcr",
    planar_candidates: bool = False,
    with_coefs: bool = True,
    trellis_lambda: float = 0.0,
):
    """Jitted device-side decode of a whole quality ladder.

    Returns fn(rgb_u8 (H, W, 3), qtabs (n_q, 2, 64) natural-order f32,
    aq_strength scalar f32 (0 = plain rounding)) ->
      (candidates (n_q, H, W, 3) u8 — or (n_q, 3, H, W) with
       planar_candidates=True, the layout the planar chunk
       scorer consumes directly (channel-last u8 tiles poorly),
       coeffs {y/cb/cr: (n_q, by, bx, 64) int16 zigzag} — or {} with
       with_coefs=False, which lets XLA drop the int16 outputs entirely
       when no byte sizes are needed).

    The candidates are what this framework's own decoder produces for the
    bytes the host entropy coder would emit from `coeffs` — so a full R-D
    sweep (encode all qualities, decode, score) runs with no host pixel
    traffic: only the int16 coefficient planes leave the device, and only
    when exact byte sizes are requested.  The reconstruction uses the exact
    float inverse DCT and libjpeg's fancy (triangle) chroma upsampling, so
    it matches a real libjpeg decode of the same bytes to ~1 u8 level RMS
    (libjpeg's integer islow iDCT is itself an approximation of the same
    float transform; test_tpujpeg.py pins the agreement).
    """
    tr = build_transform(height, width, subsampling, colorspace)
    wmat = jnp.asarray(_zigzag_dct_matrix())
    zz = jnp.asarray(ZIGZAG)

    # DC (zigzag index 0) always rounds to nearest; a select against an
    # iota mask, NOT `.at[..., 0].set` — the scatter that lowering produces
    # under vmap dominated the whole reconstruct cost (~2x) before.
    dc_mask = (np.arange(64) == 0)

    def quantize_dev(dct_zz, q_zz, bias2d):
        scaled = jnp.abs(dct_zz) / q_zz
        b = jnp.where(jnp.asarray(dc_mask), 0.5, bias2d[..., None])
        qc = jnp.minimum(jnp.floor(scaled + b), 1023.0)
        # Keep f32 for the reconstruct branch; int16 only at the output.
        return jnp.sign(dct_zz) * qc

    def reconstruct_plane(coef_zz_f32, q_zz):
        deq = coef_zz_f32 * q_zz
        flat = jnp.einsum(
            "kp,...k->...p", wmat, deq, precision=jax.lax.Precision.HIGHEST
        )
        blocks = flat.reshape(*flat.shape[:-1], 8, 8)
        return _unblockify(blocks) + 128.0

    def sweep(rgb_u8, qtabs, aq_strength):
        planes = tr(rgb_u8)
        s = jnp.asarray(aq_strength, jnp.float32)
        # Same mapping as TpuJpegCodec._bias (kept in lockstep).
        bias_y = jnp.clip(0.5 - s * planes["act_y"], 0.2, 0.5)
        bias_c = jnp.clip(0.5 - s * planes["act_c"], 0.2, 0.5)

        def one_quality(q2):
            ql_zz = q2[0][zz]
            qc_zz = q2[1][zz]
            if trellis_lambda > 0.0:
                # Device trellis DP with the static rate tables; replaces
                # the AQ bias exactly as the host path does.
                cy = trellis_quantize_dev(
                    planes["dct_y"], ql_zz, DEFAULT_AC_LENGTHS_LUMA,
                    trellis_lambda,
                )
                ccb = trellis_quantize_dev(
                    planes["dct_cb"], qc_zz, DEFAULT_AC_LENGTHS_CHROMA,
                    trellis_lambda,
                )
                ccr = trellis_quantize_dev(
                    planes["dct_cr"], qc_zz, DEFAULT_AC_LENGTHS_CHROMA,
                    trellis_lambda,
                )
            else:
                cy = quantize_dev(planes["dct_y"], ql_zz, bias_y)
                ccb = quantize_dev(planes["dct_cb"], qc_zz, bias_c)
                ccr = quantize_dev(planes["dct_cr"], qc_zz, bias_c)
            y = reconstruct_plane(cy, ql_zz)
            cb = reconstruct_plane(ccb, qc_zz)
            cr = reconstruct_plane(ccr, qc_zz)
            if subsampling in ("420", "422"):
                cb, cr = _triangle_up_h(cb), _triangle_up_h(cr)
            if subsampling in ("420", "440"):
                cb, cr = _triangle_up_v(cb), _triangle_up_v(cr)
            if colorspace == "xyb":
                rgb = _scaled_xyb_to_rgb_u8(y, cb, cr, planar=planar_candidates)
            else:
                rgb = _ycbcr_to_rgb_u8(y, cb, cr, planar=planar_candidates)
            rgb = (
                rgb[:, :height, :width]
                if planar_candidates
                else rgb[:height, :width, :]
            )
            if not with_coefs:
                return rgb, ()
            return rgb, (
                cy.astype(jnp.int16),
                ccb.astype(jnp.int16),
                ccr.astype(jnp.int16),
            )

        cands, coefs = jax.vmap(one_quality)(qtabs)
        if not with_coefs:
            return cands, {}
        return cands, {"y": coefs[0], "cb": coefs[1], "cr": coefs[2]}

    return jax.jit(sweep)


@functools.lru_cache(maxsize=32)
def build_jpeg_decode(
    height: int,
    width: int,
    subsampling: str = "420",
    colorspace: str = "ycbcr",
    planar: bool = False,
    batch: bool = False,
):
    """Jitted device JPEG decode from entropy-decoded coefficients.

    fn(cy (byY, bxY, 64) int zigzag, ccb, ccr (byC, bxC, 64),
    qtab_luma_zz (64,) f32/int, qtab_chroma_zz) -> (H, W, 3) u8 (or
    (3, H, W) with planar=True — the chunk scorer's layout).

    The second half of device-side JPEG decoding: the host stops at the
    Huffman parse (native/jpeg_huff_decode.cpp via
    utils.native.jpeg_parse_coefficients) and this program runs the
    dequantization, exact float inverse DCT, and libjpeg-style fancy
    (triangle) chroma upsampling on the accelerator.  colorspace="xyb"
    inverts the tpujpeg Adobe-transform-0 opsin container instead of
    BT.601.  Matches libjpeg's decode of the same stream to ~0.6 u8 RMS
    (its integer islow iDCT approximates the same float transform).

    reference: the reference decodes entirely on host
    (src/decode.rs:41-98 and every codec adapter's decode_fn).

    subsampling "400" decodes grayscale streams: the chroma arguments are
    accepted (shape-stable dummies) but unused, and the luma replicates
    into all three channels — the reference's L8 policy (decode.rs:60-66).
    """
    if subsampling not in ("420", "444", "422", "440", "400"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    wmat = jnp.asarray(_zigzag_dct_matrix())

    def rp(coef_zz, q_zz):
        deq = coef_zz.astype(jnp.float32) * q_zz.astype(jnp.float32)
        flat = jnp.einsum(
            "kp,...k->...p", wmat, deq, precision=jax.lax.Precision.HIGHEST
        )
        blocks = flat.reshape(*flat.shape[:-1], 8, 8)
        return _unblockify(blocks) + 128.0

    def decode(cy, ccb, ccr, ql_zz, qc_zz):
        y = rp(cy, ql_zz)
        if subsampling == "400":
            g = jnp.clip(jnp.round(y), 0.0, 255.0).astype(jnp.uint8)
            rgb = jnp.stack([g, g, g], axis=0 if planar else -1)
            return (
                rgb[:, :height, :width] if planar else rgb[:height, :width, :]
            )
        cb = rp(ccb, qc_zz)
        cr = rp(ccr, qc_zz)
        if subsampling in ("420", "422"):
            cb, cr = _triangle_up_h(cb), _triangle_up_h(cr)
        if subsampling in ("420", "440"):
            cb, cr = _triangle_up_v(cb), _triangle_up_v(cr)
        if colorspace == "xyb":
            rgb = _scaled_xyb_to_rgb_u8(y, cb, cr, planar=planar)
        else:
            rgb = _ycbcr_to_rgb_u8(y, cb, cr, planar=planar)
        return rgb[:, :height, :width] if planar else rgb[:height, :width, :]

    # batch=True: one dispatch decodes a whole candidate ladder (leading
    # axis on every argument) — per-candidate dispatches pay a round trip
    # each on a remote runtime.
    return jax.jit(jax.vmap(decode)) if batch else jax.jit(decode)


def quantize_blocks(
    dct_zz: np.ndarray,
    qtable_natural: np.ndarray,
    bias: np.ndarray | float = 0.5,
) -> np.ndarray:
    """Deadzone-quantize zigzag-order DCT blocks on the host.

    bias is the rounding offset per block ((by, bx) or scalar): 0.5 is
    round-to-nearest; smaller values widen the zero deadzone of the AC
    coefficients (DC always rounds to nearest — DC banding is never
    masked).  quantized = sign(F) * floor(|F| / q + bias).
    """
    q = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]
    scaled = np.abs(dct_zz) / q
    b = np.broadcast_to(
        np.float32(bias)[..., None]
        if isinstance(bias, np.ndarray)
        else np.float32(bias),
        scaled.shape,
    ).copy()
    b[..., 0] = 0.5
    qc = np.floor(scaled + b)
    # Baseline Huffman caps AC magnitude categories at 10 bits; clamp the
    # (pathological, q=1 synthetic-only) overflow rather than emit an
    # undecodable symbol.
    qc = np.minimum(qc, 1023.0)
    return (np.sign(dct_zz) * qc).astype(np.int16)


# -- trellis quantization -----------------------------------------------------
#
# Rate-distortion-optimal AC coefficient selection, the standard-decodable
# encoder technique mozjpeg ships as "trellis" and the reference's AVIF
# ladder names a preset after (crates/codec-iter/src/avif_config.rs:33-68,
# `qm-trellis`).  Independent formulation: per block, choose quantized AC
# values minimizing
#
#     J = sum_k (x_k - c_k)^2  +  lambda * bits
#
# where x_k = |F_k| / q_k.  Measuring distortion in quantizer-step units
# makes the q-table itself the perceptual weighting, so one scale-free
# lambda works across qualities and frequencies.  bits comes from an
# optimized-Huffman length model built from THIS image's round-to-nearest
# statistics — self-consistent with the two-pass optimized-Huffman entropy
# coder that ultimately writes the file (native/jpeg_entropy.cpp).


def _ac_bit_sizes(mag: np.ndarray) -> np.ndarray:
    """JPEG magnitude category (bit length) of non-negative int magnitudes."""
    out = np.zeros(mag.shape, dtype=np.int64)
    m = mag.astype(np.int64)
    while np.any(m):
        nz = m > 0
        out[nz] += 1
        m >>= 1
    return out


def ac_symbol_histogram(qz: np.ndarray, hist: "np.ndarray | None" = None) -> np.ndarray:
    """Histogram of baseline AC (run, size) symbols (256 bins, run<<4|size)
    produced by run-length coding the given zigzag quantized blocks."""
    if hist is None:
        hist = np.zeros(256, dtype=np.int64)
    q = np.abs(qz.reshape(-1, 64).astype(np.int64))
    run = np.zeros(q.shape[0], dtype=np.int64)
    for k in range(1, 64):
        c = q[:, k]
        nz = c > 0
        if np.any(nz):
            r = run[nz]
            hist[0xF0] += int((r // 16).sum())
            sizes = _ac_bit_sizes(c[nz])
            np.add.at(hist, ((r % 16) << 4) | sizes, 1)
            run[nz] = 0
        run[~nz] += 1
    hist[0x00] += int((run > 0).sum())  # EOB for blocks with a zero tail
    return hist


def huffman_code_lengths(freq: np.ndarray, default: int = 16) -> np.ndarray:
    """Huffman code length per symbol for the given frequencies (unseen
    symbols get ``default``).  Unlimited-depth lengths are an adequate rate
    model; the entropy coder builds its own canonical 16-bit-limited codes."""
    import heapq

    idx = np.flatnonzero(freq)
    lengths = np.full(freq.shape[0], float(default), dtype=np.float32)
    if idx.size == 0:
        return lengths
    if idx.size == 1:
        lengths[idx[0]] = 1.0
        return lengths
    depth = np.zeros(freq.shape[0], dtype=np.float32)
    heap = [(int(freq[i]), int(i), [int(i)]) for i in idx]
    heapq.heapify(heap)
    tiebreak = int(freq.shape[0])
    while len(heap) > 1:
        fa, _, la = heapq.heappop(heap)
        fb, _, lb = heapq.heappop(heap)
        merged = la + lb
        depth[merged] += 1.0
        heapq.heappush(heap, (fa + fb, tiebreak, merged))
        tiebreak += 1
    lengths[idx] = depth[idx]
    return lengths


def ac_code_lengths(planes) -> np.ndarray:
    """(16, 11) bit-length model for AC (run, size) symbols, from an
    optimized-Huffman fit to the given quantized planes (a list of zigzag
    int16 block arrays of one table class — luma, or both chroma)."""
    hist = np.zeros(256, dtype=np.int64)
    for qz in planes:
        ac_symbol_histogram(qz, hist)
    lengths = huffman_code_lengths(hist)
    table = np.full((16, 11), 16.0, dtype=np.float32)
    for run in range(16):
        for size in range(11):
            sym = (run << 4) | size
            if size > 0 or run in (0, 15):  # valid symbols: EOB, ZRL, (r,s>0)
                table[run, size] = lengths[sym]
    return table


def trellis_quantize_blocks(
    dct_zz: np.ndarray,
    qtable_natural: np.ndarray,
    ac_lengths: np.ndarray,
    lmbda: "float | np.ndarray" = 0.35,
) -> np.ndarray:
    """Rate-distortion-optimal quantization of zigzag-order DCT blocks.

    Dynamic program over the 63 AC positions of every block (vectorized
    across blocks): state = position of the previous nonzero coefficient;
    transitions pay the zeroed coefficients' distortion, the (run, size)
    symbol bits (ZRL chains for runs >= 16), and the appended magnitude
    bits; candidates per position are round-to-nearest and one step toward
    zero.  Distortion is (|F|/q - c)^2 — quantizer-step units, so ``lmbda``
    is scale-free across qualities.  ``lmbda`` may be a per-block array
    (the block-grid shape of ``dct_zz[..., 0]``) for activity-modulated
    trellis.  DC always rounds to nearest (as ``quantize_blocks``).
    Returns int16 zigzag blocks, same shape.
    """
    q = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]
    lam = np.asarray(lmbda, dtype=np.float32)
    if lam.ndim == 0:
        # Hot path: the C++ DP (native/jpeg_trellis.cpp) mirrors the numpy
        # implementation below operation-for-operation; tests pin equality.
        from ..utils.native import trellis_quantize_native

        native_out = trellis_quantize_native(
            dct_zz, q, ac_lengths, float(lam)
        )
        if native_out is not None:
            return native_out
    lead = dct_zz.shape[:-1]
    F = dct_zz.reshape(-1, 64).astype(np.float32)
    B = F.shape[0]
    lam_b = np.full(B, float(lam), np.float32) if lam.ndim == 0 else lam.reshape(B)
    x = np.abs(F) / q  # (B, 64)
    sign = np.sign(F)

    c0 = np.minimum(np.floor(x + 0.5), 1023.0)  # round-to-nearest magnitude
    c1 = np.maximum(c0 - 1.0, 0.0)  # one step toward zero
    cands = np.stack([c0, c1])  # (2, B, 64)
    csize = _ac_bit_sizes(cands.astype(np.int64)).astype(np.int64)  # (2,B,64)

    L = np.asarray(ac_lengths, dtype=np.float32)  # (16, 11)
    l_zrl = float(L[15, 0])
    l_eob = float(L[0, 0])

    # Zero-distortion prefix sums over AC: P[:, j] = sum_{1<=i<=j} x_i^2.
    P = np.zeros((B, 64), dtype=np.float32)
    np.cumsum(x[:, 1:] ** 2, axis=1, out=P[:, 1:])

    NEG = np.float32(np.inf)
    best = np.full((B, 64), NEG, dtype=np.float32)
    best[:, 0] = 0.0  # state 0: no nonzero AC yet
    prev = np.zeros((B, 64), dtype=np.int8)
    vals = np.zeros((B, 64), dtype=np.int16)

    for k in range(1, 64):
        j = np.arange(k)  # previous nonzero position (0 = none yet)
        r = k - 1 - j  # zero-run length, (k,)
        runbits = (r // 16).astype(np.float32) * l_zrl  # ZRL chain
        Lr = L[r % 16]  # (k, 11)
        dist_zero = P[:, k - 1][None, :] - P[:, j].T  # (k, B)
        base = best[:, :k].T + dist_zero  # (k, B)
        # Candidate costs: (2, k, B)
        total = np.full((2, k, B), NEG, dtype=np.float32)
        for ci in range(2):
            c = cands[ci, :, k]  # (B,)
            valid = c > 0
            if not np.any(valid):
                continue
            s = csize[ci, :, k]  # (B,)
            sym_bits = Lr[:, s] + s.astype(np.float32)[None, :]  # (k, B)
            d = (x[:, k] - c) ** 2  # (B,)
            t = base + lam_b[None, :] * (runbits[:, None] + sym_bits) + d[None, :]
            total[ci] = np.where(valid[None, :], t, NEG)
        flat = total.reshape(2 * k, B)
        pick = np.argmin(flat, axis=0)  # (B,)
        best[:, k] = flat[pick, np.arange(B)]
        prev[:, k] = (pick % k).astype(np.int8)
        vals[:, k] = cands[pick // k, np.arange(B), k].astype(np.int16)

    # Terminate: zero tail after last nonzero j, EOB unless j == 63.
    j = np.arange(64)
    tail = P[:, 63][:, None] - P[:, j][None, :].reshape(B, 64)
    end_bits = np.where(j < 63, l_eob, 0.0).astype(np.float32)
    # State 0 with a fully-zero block still needs its EOB.
    totals = best + tail + lam_b[:, None] * end_bits[None, :]
    jlast = np.argmin(totals, axis=1)  # (B,)

    out = np.zeros((B, 64), dtype=np.int16)
    out[:, 0] = (sign[:, 0] * np.minimum(np.floor(x[:, 0] + 0.5), 2047.0)).astype(
        np.int16
    )
    cur = jlast.astype(np.int64)
    for k in range(63, 0, -1):
        on = cur == k
        if np.any(on):
            out[on, k] = (sign[on, k] * vals[on, k]).astype(np.int16)
            cur[on] = prev[on, k]
    return out.reshape(*lead, 64)


def trellis_quantize_dev(
    dct_zz: jnp.ndarray,
    q_zz: jnp.ndarray,
    ac_lengths: np.ndarray,
    lmbda: float,
) -> jnp.ndarray:
    """Device (jittable/vmappable) trellis DP, same objective as
    ``trellis_quantize_blocks`` — used by the device-resident ladder.

    Array-shaped reformulation of the DP step: the (run, size) bit lookup
    is a one-hot (B, 11) x (11, 63) matmul against a run-table followed by
    a flip+roll realignment (no gathers or scatters); state updates are
    iota-mask selects.  The rate model is a
    STATIC table — the fitted-vs-fixed experiment measured the per-image
    Huffman fit worth 0.01 BD-rate points, so a corpus-level table loses
    nothing and keeps the whole ladder on device.  Returns f32 signed
    quantized values (the reconstruct path consumes f32; cast at output),
    matching the ``quantize_dev`` contract.
    """
    lengths = np.asarray(ac_lengths, dtype=np.float32)
    # RT[r, s] = ZRL-chain bits + symbol bits + appended magnitude bits
    # for a zero-run r before a size-s coefficient.
    r = np.arange(63)
    RT = (
        (r // 16).astype(np.float32)[:, None] * lengths[15, 0]
        + lengths[r % 16]  # (63, 11)
        + np.arange(11, dtype=np.float32)[None, :]
    )
    RTj = jnp.asarray(RT.T)  # (11, 63)
    l_eob = float(lengths[0, 0])
    lam = jnp.float32(lmbda)

    lead = dct_zz.shape[:-1]
    F = dct_zz.reshape(-1, 64)
    B = F.shape[0]
    x = jnp.abs(F) / q_zz
    sgn = jnp.sign(F)
    c0 = jnp.minimum(jnp.floor(x + 0.5), 1023.0)
    c1 = jnp.maximum(c0 - 1.0, 0.0)

    def size_of(c):
        return jnp.where(
            c > 0.0,
            jnp.floor(jnp.log2(jnp.maximum(c, 1.0))).astype(jnp.int32) + 1,
            0,
        )

    sizes = jnp.stack([size_of(c0), size_of(c1)])  # (2, B, 64) int32
    cands = jnp.stack([c0, c1])  # (2, B, 64)

    P = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.float32), jnp.cumsum(x[:, 1:] ** 2, axis=1)],
        axis=1,
    )  # (B, 64): P[:, j] = sum_{1<=i<=j} x_i^2

    INF = jnp.float32(np.inf)
    iota = jnp.arange(64)
    best0 = jnp.broadcast_to(jnp.where(iota == 0, 0.0, INF), (B, 64))
    prev0 = jnp.zeros((B, 64), jnp.int32)
    vals0 = jnp.zeros((B, 64), jnp.float32)

    def step(carry, k):
        best, prev, vals = carry
        x_k = jax.lax.dynamic_index_in_dim(x, k, axis=1, keepdims=False)
        p_km1 = jax.lax.dynamic_index_in_dim(P, k - 1, axis=1, keepdims=False)

        def cand_cost(ci):
            c = jax.lax.dynamic_index_in_dim(cands[ci], k, 1, keepdims=False)
            s = jax.lax.dynamic_index_in_dim(sizes[ci], k, 1, keepdims=False)
            onehot = jax.nn.one_hot(s, 11, dtype=jnp.float32)  # (B, 11)
            m = onehot @ RTj  # (B, 63): bits for run r at column r
            mp = jnp.pad(m, ((0, 0), (0, 1)))  # (B, 64)
            # bits[:, j] = mp[:, k-1-j (mod 64)]; wrapped columns (j >= k)
            # are masked by best[j] = +inf.
            bits = jnp.roll(jnp.flip(mp, axis=1), k, axis=1)
            d = (x_k - c) ** 2
            cost = best + (p_km1[:, None] - P) + lam * bits + d[:, None]
            return jnp.where(c[:, None] > 0.0, cost, INF), c

        cost_a, ca = cand_cost(0)
        cost_b, cb = cand_cost(1)
        both = jnp.concatenate([cost_a, cost_b], axis=1)  # (B, 128)
        flat = jnp.argmin(both, axis=1)
        best_k = jnp.take_along_axis(both, flat[:, None], axis=1)[:, 0]
        prev_k = (flat % 64).astype(jnp.int32)
        val_k = jnp.where(flat < 64, ca, cb)

        on = (iota[None, :] == k)
        best = jnp.where(on, best_k[:, None], best)
        prev = jnp.where(on, prev_k[:, None], prev)
        vals = jnp.where(on, val_k[:, None], vals)
        return (best, prev, vals), None

    (best, prev, vals), _ = jax.lax.scan(
        step, (best0, prev0, vals0), jnp.arange(1, 64)
    )

    totals = best + (P[:, 63:64] - P) + lam * l_eob * (iota < 63)[None, :]
    cur0 = jnp.argmin(totals, axis=1).astype(jnp.int32)

    def back(cur, k):
        on = cur == k
        col = jnp.where(
            on,
            jax.lax.dynamic_index_in_dim(sgn, k, 1, keepdims=False)
            * jax.lax.dynamic_index_in_dim(vals, k, 1, keepdims=False),
            0.0,
        )
        nxt = jnp.where(
            on, jax.lax.dynamic_index_in_dim(prev, k, 1, keepdims=False), cur
        )
        return nxt, col

    _, cols = jax.lax.scan(back, cur0, jnp.arange(63, 0, -1))
    # cols[i] is column k = 63 - i; assemble (B, 64) with DC at 0.
    ac = jnp.flip(cols, axis=0).T  # (B, 63) columns 1..63
    dc = sgn[:, 0] * jnp.minimum(jnp.floor(x[:, 0] + 0.5), 2047.0)
    out = jnp.concatenate([dc[:, None], ac], axis=1)
    return out.reshape(*lead, 64)
