"""Golden Butteraugli oracle via the system libjxl C API (test/calibration only).

The production Butteraugli metric in this framework is the JAX kernel in
``codec_eval_tpu.kernels.butteraugli``.  This module binds the butteraugli
implementation exported by the system's ``libjxl`` shared library purely as a
*golden reference* for parity tests and constant calibration — the JAX build
must match it, the way the reference repo's wrapper matches the upstream
butteraugli crate (reference: src/metrics/butteraugli.rs:45-135).

Not available on machines without libjxl; guard with ``is_available()``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_LIB_CANDIDATES = [
    "libjxl.so.0.7",
    "libjxl.so.0",
    "libjxl.so",
]


class _JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),  # JXL_TYPE_UINT8 == 2
        ("endianness", ctypes.c_int),  # native == 0
        ("align", ctypes.c_size_t),
    ]


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for name in _LIB_CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            lib.JxlButteraugliApiCreate.restype = ctypes.c_void_p
            lib.JxlButteraugliApiCreate.argtypes = [ctypes.c_void_p]
            lib.JxlButteraugliApiDestroy.argtypes = [ctypes.c_void_p]
            lib.JxlButteraugliApiSetIntensityTarget.argtypes = [
                ctypes.c_void_p,
                ctypes.c_float,
            ]
            lib.JxlButteraugliApiSetHFAsymmetry.argtypes = [
                ctypes.c_void_p,
                ctypes.c_float,
            ]
            lib.JxlButteraugliCompute.restype = ctypes.c_void_p
            lib.JxlButteraugliCompute.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint32,
                ctypes.c_uint32,
                ctypes.POINTER(_JxlPixelFormat),
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.POINTER(_JxlPixelFormat),
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.JxlButteraugliResultGetDistance.restype = ctypes.c_float
            lib.JxlButteraugliResultGetDistance.argtypes = [
                ctypes.c_void_p,
                ctypes.c_float,
            ]
            lib.JxlButteraugliResultGetMaxDistance.restype = ctypes.c_float
            lib.JxlButteraugliResultGetMaxDistance.argtypes = [ctypes.c_void_p]
            lib.JxlButteraugliResultGetDistmap.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.JxlButteraugliResultDestroy.argtypes = [ctypes.c_void_p]
        except AttributeError:
            continue
        _lib = lib
        return lib
    return None


def is_available() -> bool:
    return _load() is not None


def butteraugli_golden(
    reference_u8: np.ndarray,
    distorted_u8: np.ndarray,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
    pnorm: Optional[float] = None,
) -> float:
    """Golden butteraugli distance of a (H, W, 3) u8 sRGB pair.

    Returns the max-norm distance by default (the classic "butteraugli
    score" the reference's thresholds are calibrated to), or the requested
    p-norm of the distance map.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libjxl not available for golden butteraugli")
    assert reference_u8.shape == distorted_u8.shape
    h, w, c = reference_u8.shape
    assert c == 3

    api = lib.JxlButteraugliApiCreate(None)
    try:
        lib.JxlButteraugliApiSetIntensityTarget(api, float(intensity_target))
        lib.JxlButteraugliApiSetHFAsymmetry(api, float(hf_asymmetry))
        fmt = _JxlPixelFormat(3, 2, 0, 0)
        a = np.ascontiguousarray(reference_u8)
        b = np.ascontiguousarray(distorted_u8)
        res = lib.JxlButteraugliCompute(
            api,
            w,
            h,
            ctypes.byref(fmt),
            a.ctypes.data,
            a.nbytes,
            ctypes.byref(fmt),
            b.ctypes.data,
            b.nbytes,
        )
        if not res:
            raise RuntimeError("JxlButteraugliCompute failed")
        try:
            if pnorm is None:
                return float(lib.JxlButteraugliResultGetMaxDistance(res))
            return float(lib.JxlButteraugliResultGetDistance(res, float(pnorm)))
        finally:
            lib.JxlButteraugliResultDestroy(res)
    finally:
        lib.JxlButteraugliApiDestroy(api)


def butteraugli_distmap(
    reference_u8: np.ndarray,
    distorted_u8: np.ndarray,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> np.ndarray:
    """Golden per-pixel butteraugli distance map (H, W)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libjxl not available for golden butteraugli")
    h, w, _ = reference_u8.shape
    api = lib.JxlButteraugliApiCreate(None)
    try:
        lib.JxlButteraugliApiSetIntensityTarget(api, float(intensity_target))
        lib.JxlButteraugliApiSetHFAsymmetry(api, float(hf_asymmetry))
        fmt = _JxlPixelFormat(3, 2, 0, 0)
        a = np.ascontiguousarray(reference_u8)
        b = np.ascontiguousarray(distorted_u8)
        res = lib.JxlButteraugliCompute(
            api, w, h,
            ctypes.byref(fmt), a.ctypes.data, a.nbytes,
            ctypes.byref(fmt), b.ctypes.data, b.nbytes,
        )
        if not res:
            raise RuntimeError("JxlButteraugliCompute failed")
        try:
            buf = ctypes.POINTER(ctypes.c_float)()
            row_stride = ctypes.c_uint32()
            lib.JxlButteraugliResultGetDistmap(
                res, ctypes.byref(buf), ctypes.byref(row_stride)
            )
            stride = row_stride.value
            flat = np.ctypeslib.as_array(buf, shape=(h, stride))
            return np.array(flat[:, :w], copy=True)
        finally:
            lib.JxlButteraugliResultDestroy(res)
    finally:
        lib.JxlButteraugliApiDestroy(api)
