"""Color-space math as pure JAX kernels (sRGB <-> linear, XYB opsin space).

Accelerator replacement for the reference's per-pixel Rust loops
(reference: src/metrics/xyb.rs:33-164, src/eval/helpers.rs:45-67).  Everything
here is shape-polymorphic over a trailing channel axis of size 3, traceable
under ``jit``/``vmap``, and runs entirely on device — no host transfers.

The XYB constants are the frozen JPEG XL / butteraugli opsin-absorbance
parameters (public constants; see jxl ``cms/opsin_params.h``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Opsin absorbance matrix (rows: L, M, S cone-ish responses).
# reference: src/metrics/xyb.rs:34-44
# NOTE: module-level constants are numpy on purpose — jnp.array at import
# time would initialize the XLA backend, breaking jax.distributed users who
# import this package before initialize() (tests/test_multihost_integration).
OPSIN_ABSORBANCE_MATRIX = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.5518098665095536],
    ],
    dtype=jnp.float32,
)

# reference: src/metrics/xyb.rs:46
OPSIN_ABSORBANCE_BIAS = np.float32(0.0037930732552754493)

# -cbrt(bias); reference: src/metrics/xyb.rs:48-52
NEG_OPSIN_ABSORBANCE_BIAS_CBRT = np.float32(-0.15595412)

# Inverse of the opsin matrix; reference: src/metrics/xyb.rs:54-57
INV_OPSIN_MATRIX = np.array(
    [
        [11.031566901960783, -9.866943921568629, -0.16462299647058826],
        [-3.254147380392157, 4.418770392156863, -0.16462299647058826],
        [-3.6588512862745097, 2.7129230470588235, 1.9459282392156863],
    ],
    dtype=jnp.float32,
)

# Empirical XYB channel ranges over all sRGB u8 inputs, slightly padded.
# reference: src/metrics/xyb.rs:185-190
XYB_RANGES = np.array(
    [[-0.016, 0.029], [0.0, 0.846], [0.0, 0.846]], dtype=jnp.float32
)


def srgb_to_linear(v: jnp.ndarray) -> jnp.ndarray:
    """sRGB [0,1] -> linear light.  reference: src/metrics/xyb.rs:60-67."""
    v = v.astype(jnp.float32)
    return jnp.where(
        v <= 0.04045,
        v / 12.92,
        jnp.power(jnp.maximum((v + 0.055) / 1.055, 0.0), 2.4),
    )


def linear_to_srgb(v: jnp.ndarray) -> jnp.ndarray:
    """Linear light -> sRGB [0,1].  reference: src/metrics/xyb.rs:70-77."""
    v = v.astype(jnp.float32)
    return jnp.where(
        v <= 0.0031308,
        v * 12.92,
        1.055 * jnp.power(jnp.maximum(v, 1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_u8_to_linear(v: jnp.ndarray) -> jnp.ndarray:
    """u8 sRGB -> linear f32.  reference: src/metrics/xyb.rs:80-83."""
    return srgb_to_linear(v.astype(jnp.float32) / 255.0)


def linear_to_srgb_u8(v: jnp.ndarray) -> jnp.ndarray:
    """Linear f32 -> u8 sRGB with round-half-away (matches Rust ``round``).
    reference: src/metrics/xyb.rs:86-89."""
    s = linear_to_srgb(jnp.clip(v, 0.0, 1.0)) * 255.0
    # Rust f32::round rounds half away from zero; values here are >= 0.
    return jnp.floor(s + 0.5).astype(jnp.uint8)


def mixed_cbrt(v: jnp.ndarray) -> jnp.ndarray:
    """Signed cube root.  reference: src/metrics/xyb.rs:93-95."""
    return jnp.cbrt(v)


def linear_rgb_to_xyb(rgb: jnp.ndarray) -> jnp.ndarray:
    """Linear RGB (..., 3) -> XYB (..., 3).

    The 3x3 matrix is applied as elementwise FMA chains rather than a
    matmul: a (..., 3) @ (3, 3) contraction would otherwise run at the
    matrix units' default reduced precision (bf16 or TF32), costing ~1e-3
    relative error — far above metric tolerance.

    reference: src/metrics/xyb.rs:104-129.
    """
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    m = OPSIN_ABSORBANCE_MATRIX
    opsin_r = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b + OPSIN_ABSORBANCE_BIAS
    opsin_g = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + OPSIN_ABSORBANCE_BIAS
    opsin_b = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + OPSIN_ABSORBANCE_BIAS
    cr = mixed_cbrt(opsin_r) + NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cg = mixed_cbrt(opsin_g) + NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cb = mixed_cbrt(opsin_b) + NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    x = 0.5 * (cr - cg)
    y = 0.5 * (cr + cg)
    return jnp.stack([x, y, cb], axis=-1)


def xyb_to_linear_rgb(xyb: jnp.ndarray) -> jnp.ndarray:
    """XYB (..., 3) -> linear RGB (..., 3).

    reference: src/metrics/xyb.rs:133-164.
    """
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    cr = (y + x) - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cg = (y - x) - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cb = b - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    opsin_r = cr * cr * cr - OPSIN_ABSORBANCE_BIAS
    opsin_g = cg * cg * cg - OPSIN_ABSORBANCE_BIAS
    opsin_b = cb * cb * cb - OPSIN_ABSORBANCE_BIAS
    inv = INV_OPSIN_MATRIX
    out_r = inv[0, 0] * opsin_r + inv[0, 1] * opsin_g + inv[0, 2] * opsin_b
    out_g = inv[1, 0] * opsin_r + inv[1, 1] * opsin_g + inv[1, 2] * opsin_b
    out_b = inv[2, 0] * opsin_r + inv[2, 1] * opsin_g + inv[2, 2] * opsin_b
    return jnp.stack([out_r, out_g, out_b], axis=-1)


def _quantize_to_u8(value: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Quantize within [lo, hi] to 255 levels.  reference: src/metrics/xyb.rs:194-199."""
    rng = hi - lo
    normalized = (value - lo) / rng
    quantized = jnp.clip(jnp.floor(normalized * 255.0 + 0.5), 0.0, 255.0) / 255.0
    return quantized * rng + lo


def xyb_roundtrip(rgb_u8: jnp.ndarray) -> jnp.ndarray:
    """Roundtrip sRGB u8 (..., 3) through u8-quantized XYB.

    Simulates 8-bit XYB storage loss for fair comparison against XYB codecs
    (e.g. jpegli).  reference: src/metrics/xyb.rs:225-253.
    """
    linear = srgb_u8_to_linear(rgb_u8)
    xyb = linear_rgb_to_xyb(linear)
    xyb_q = _quantize_to_u8(xyb, XYB_RANGES[:, 0], XYB_RANGES[:, 1])
    out_linear = xyb_to_linear_rgb(xyb_q)
    return linear_to_srgb_u8(out_linear)
