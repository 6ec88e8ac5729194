"""ctypes binding for the native host runtime (native/codec_eval_native.cpp)
with pure-Python fallbacks.

The native library accelerates host-side staging work around the device compute
path: FNV-1a checksums, PPM cache IO, sRGB->linear LUT conversion, batch
padding.  Build with ``make -C native``; everything degrades gracefully to
numpy/Python when the .so is absent.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SO_CANDIDATES = [
    _REPO_ROOT / "native" / "libcodec_eval_native.so",
    Path(os.environ.get("CODEC_EVAL_NATIVE", "/nonexistent")),
]

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _try_build() -> None:
    """Best-effort `make -C native` so a fresh checkout gets the fast paths
    (and the JPEG entropy coder) without a manual build step."""
    import shutil
    import subprocess

    if not shutil.which("make") or not (_REPO_ROOT / "native" / "Makefile").exists():
        return
    try:
        subprocess.run(
            ["make", "-C", str(_REPO_ROOT / "native")],
            capture_output=True,
            timeout=120,
            check=False,
        )
    except Exception:
        pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    if not any(c.exists() for c in _SO_CANDIDATES):
        _try_build()
    for cand in _SO_CANDIDATES:
        if not cand.exists():
            continue
        try:
            lib = ctypes.CDLL(str(cand))
            lib.ce_fnv1a64.restype = ctypes.c_uint64
            lib.ce_fnv1a64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.ce_fnv1a64_file.restype = ctypes.c_uint64
            lib.ce_fnv1a64_file.argtypes = [ctypes.c_char_p]
            lib.ce_srgb_to_linear.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.ce_pad_image_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ]
            lib.ce_write_ppm.restype = ctypes.c_int
            lib.ce_write_ppm.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ]
            lib.ce_read_ppm.restype = ctypes.c_int
            lib.ce_read_ppm.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ]
            if hasattr(lib, "ce_trellis_quantize"):
                lib.ce_trellis_quantize.restype = ctypes.c_int64
                lib.ce_trellis_quantize.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                ]
            for sym in ("ce_jpeg_encode_baseline2", "ce_jpeg_encode_progressive"):
                if hasattr(lib, sym):
                    fn = getattr(lib, sym)
                    fn.restype = ctypes.c_int64
                    fn.argtypes = [
                        ctypes.c_uint16, ctypes.c_uint16, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_uint32, ctypes.c_uint32,
                        ctypes.c_uint32, ctypes.c_uint32,
                        ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                    ]
            if hasattr(lib, "ce_jpeg_scan_stats"):
                lib.ce_jpeg_scan_stats.restype = ctypes.c_int64
                lib.ce_jpeg_scan_stats.argtypes = [
                    ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
            if hasattr(lib, "ce_jpeg_parse"):
                lib.ce_jpeg_parse.restype = ctypes.c_int64
                lib.ce_jpeg_parse.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
            if hasattr(lib, "ce_jpeg_scan_stats_progressive"):
                lib.ce_jpeg_scan_stats_progressive.restype = ctypes.c_int64
                lib.ce_jpeg_scan_stats_progressive.argtypes = [
                    ctypes.c_uint16, ctypes.c_uint16, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
            _lib = lib
            return lib
        except OSError:
            continue
    return None


def is_native_available() -> bool:
    return _load() is not None


def fnv1a64(data: bytes | np.ndarray) -> int:
    lib = _load()
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data)
        buf, n = data.ctypes.data, data.nbytes
        if lib:
            return int(lib.ce_fnv1a64(buf, n))
        data = data.tobytes()
    elif lib:
        return int(lib.ce_fnv1a64(data, len(data)))
    from ..corpus.checksum import fnv1a_64

    return fnv1a_64(data)


def fnv1a64_file(path) -> int:
    lib = _load()
    if lib:
        v = int(lib.ce_fnv1a64_file(str(path).encode()))
        if v != 0:
            return v
        # 0 signals open failure; fall through to raise via Python path.
    from ..corpus.checksum import fnv1a_64_file

    return fnv1a_64_file(Path(path))


def srgb_to_linear_host(u8: np.ndarray) -> np.ndarray:
    """Host-side sRGB u8 -> linear f32 (LUT), for infeed staging."""
    u8 = np.ascontiguousarray(u8)
    out = np.empty(u8.shape, dtype=np.float32)
    lib = _load()
    if lib:
        lib.ce_srgb_to_linear(u8.ctypes.data, out.ctypes.data, u8.size)
        return out
    lut = _py_lut()
    return lut[u8]


_PY_LUT: Optional[np.ndarray] = None


def _py_lut() -> np.ndarray:
    global _PY_LUT
    if _PY_LUT is None:
        v = np.arange(256, dtype=np.float64) / 255.0
        _PY_LUT = np.where(
            v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4
        ).astype(np.float32)
    return _PY_LUT


def pad_image_u8(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """(h, w, 3) u8 -> zero-padded (ph, pw, 3) u8."""
    h, w = img.shape[:2]
    lib = _load()
    out = np.empty((ph, pw, 3), dtype=np.uint8)
    if lib:
        img = np.ascontiguousarray(img)
        lib.ce_pad_image_u8(img.ctypes.data, h, w, out.ctypes.data, ph, pw)
        return out
    out[:] = 0
    out[:h, :w] = img
    return out


def write_ppm(path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    lib = _load()
    if lib:
        rgb = np.ascontiguousarray(rgb)
        rc = lib.ce_write_ppm(str(path).encode(), rgb.ctypes.data, w, h)
        if rc != 0:
            raise IOError(f"ce_write_ppm failed ({rc}) for {path}")
        return
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def jpeg_entropy_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "ce_jpeg_encode_baseline2")


def jpeg_encode_baseline(
    width: int,
    height: int,
    subsampling: str,
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
    qtab_luma_zz: np.ndarray,
    qtab_chroma_zz: np.ndarray,
    app_mode: int = 0,
    progressive: bool = False,
) -> bytes:
    """Entropy-code quantized zigzag coefficient planes into a baseline
    JPEG bytestream with optimized Huffman tables (native/jpeg_entropy.cpp).

    Coefficient planes are int16 (by, bx, 64); qtables are uint16[64] in
    ZIGZAG order.  subsampling is "420" or "444".  app_mode 0 emits a JFIF
    (YCbCr) container; 1 emits Adobe APP14 transform-0 (channels pass
    through undecoded — used by the XYB colorspace mode).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "ce_jpeg_encode_baseline2"):
        raise RuntimeError(
            "native JPEG entropy coder unavailable; build with `make -C native`"
        )
    y = np.ascontiguousarray(y_coeffs, dtype=np.int16)
    cb = np.ascontiguousarray(cb_coeffs, dtype=np.int16)
    cr = np.ascontiguousarray(cr_coeffs, dtype=np.int16)
    ql = np.ascontiguousarray(qtab_luma_zz, dtype=np.uint16)
    qc = np.ascontiguousarray(qtab_chroma_zz, dtype=np.uint16)
    # Worst-case entropy-coded size can exceed the raw int16 bytes (a dense
    # plane of large magnitudes costs up to ~27 bits per coefficient);
    # 2x raw + headers covers it with room to spare.
    cap = 2 * (y.nbytes + cb.nbytes + cr.nbytes) + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    entry = (
        lib.ce_jpeg_encode_progressive if progressive
        else lib.ce_jpeg_encode_baseline2
    )
    sub_code = {"444": 0, "420": 1, "422": 2, "440": 3}[subsampling]
    n = entry(
        width, height, sub_code,
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        y.shape[0], y.shape[1], cb.shape[0], cb.shape[1],
        ql.ctypes.data, qc.ctypes.data,
        out.ctypes.data, cap, int(app_mode),
    )
    if n < 0:
        raise RuntimeError("jpeg entropy coder failed (buffer/args)")
    return out[:n].tobytes()


def jpeg_scan_stats(
    subsampling: str,
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
) -> dict:
    """Exact baseline-scan statistics from the C++ entropy coder — the test
    oracle for the device-side rate accounting (kernels/jpeg_rate.py).

    Returns {"dc_freq": (2, 256) u32, "ac_freq": (2, 256) u32,
    "scan_bytes": int (flush-padded, headers/EOI excluded),
    "stuffed": int (0x00 bytes inserted after 0xFF)}.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "ce_jpeg_scan_stats"):
        raise RuntimeError(
            "native JPEG scan stats unavailable; build with `make -C native`"
        )
    y = np.ascontiguousarray(y_coeffs, dtype=np.int16)
    cb = np.ascontiguousarray(cb_coeffs, dtype=np.int16)
    cr = np.ascontiguousarray(cr_coeffs, dtype=np.int16)
    dc_freq = np.zeros((2, 256), dtype=np.uint32)
    ac_freq = np.zeros((2, 256), dtype=np.uint32)
    cap = 2 * (y.nbytes + cb.nbytes + cr.nbytes) + (1 << 16)
    scratch = np.empty(cap, dtype=np.uint8)
    scan_bytes = ctypes.c_int64()
    stuffed = ctypes.c_int64()
    sub_code = {"444": 0, "420": 1, "422": 2, "440": 3}[subsampling]
    rc = lib.ce_jpeg_scan_stats(
        sub_code,
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        y.shape[0], y.shape[1], cb.shape[0], cb.shape[1],
        dc_freq.ctypes.data, ac_freq.ctypes.data,
        scratch.ctypes.data, cap,
        ctypes.byref(scan_bytes), ctypes.byref(stuffed),
    )
    if rc != 0:
        raise RuntimeError("jpeg scan stats failed (buffer/args)")
    return {
        "dc_freq": dc_freq,
        "ac_freq": ac_freq,
        "scan_bytes": int(scan_bytes.value),
        "stuffed": int(stuffed.value),
    }


def jpeg_parse_coefficients(data: bytes) -> dict:
    """Entropy-decode a JPEG stream to quantized zigzag coefficient planes
    (native/jpeg_huff_decode.cpp) — the host half of device-side JPEG
    decoding.  Handles baseline (SOF0/SOF1) and progressive (SOF2,
    spectral selection + successive approximation), 3-component 8-bit
    Huffman streams with restart markers.

    Returns {"width", "height", "subsampling" ("444"/"420"/"422"/"440",
    or "400" for grayscale — chroma planes are then 1x1 dummies),
    "progressive" bool, "adobe_transform" (None or int),
    "y"/"cb"/"cr": (by, bx, 64) int16 zigzag on the padded MCU grid,
    "qtab_luma_zz"/"qtab_chroma_zz": uint16[64]}.

    Raises UnsupportedFormat for streams outside that envelope (CMYK,
    12-bit, arithmetic, hierarchical), ValueError on corrupt data.
    """
    from ..errors import UnsupportedFormat

    lib = _load()
    if lib is None or not hasattr(lib, "ce_jpeg_parse"):
        raise RuntimeError(
            "native JPEG parser unavailable; build with `make -C native`"
        )
    buf = np.frombuffer(data, dtype=np.uint8)
    hdr = np.zeros(16, dtype=np.uint32)
    rc = lib.ce_jpeg_parse(
        buf.ctypes.data, buf.nbytes, hdr.ctypes.data, None, None, None,
        None, None,
    )
    if rc == -2:
        raise UnsupportedFormat(
            "JPEG stream outside the supported envelope "
            "(need 8-bit Huffman, 3-component 444/420/422/440 or grayscale)"
        )
    if rc != 0:
        raise ValueError("corrupt JPEG stream")
    w, h = int(hdr[0]), int(hdr[1])
    by_y, bx_y, by_c, bx_c = (int(x) for x in hdr[5:9])
    sh, sv = int(hdr[3]), int(hdr[4])
    gray = int(hdr[2]) == 1
    if w < 1 or h < 1:
        raise ValueError("corrupt JPEG stream (zero dimensions)")
    # Sanity cap before allocating coefficient planes: a corrupt SOF can
    # claim 65535x65535 (a >8 GB int16 allocation per plane).  Real use
    # tops out well below this; reject rather than thrash.
    if w * h > 64 * 1024 * 1024:
        raise ValueError(
            f"JPEG dimensions {w}x{h} exceed the 64-megapixel sanity cap"
        )
    sub = (
        "400"
        if gray
        else {(1, 1): "444", (2, 2): "420", (2, 1): "422", (1, 2): "440"}[
            (sh, sv)
        ]
    )
    y = np.zeros((by_y, bx_y, 64), dtype=np.int16)
    # Grayscale streams have no chroma planes; shape-stable dummies keep
    # the device decode signature uniform.
    cb = np.zeros((max(by_c, 1), max(bx_c, 1), 64), dtype=np.int16)
    cr = np.zeros((max(by_c, 1), max(bx_c, 1), 64), dtype=np.int16)
    ql = np.zeros(64, dtype=np.uint16)
    qc = np.zeros(64, dtype=np.uint16)
    rc = lib.ce_jpeg_parse(
        buf.ctypes.data, buf.nbytes, hdr.ctypes.data,
        y.ctypes.data,
        None if gray else cb.ctypes.data,
        None if gray else cr.ctypes.data,
        ql.ctypes.data, qc.ctypes.data,
    )
    if rc != 0:
        raise ValueError("corrupt JPEG stream (entropy decode failed)")
    return {
        "width": w,
        "height": h,
        "subsampling": sub,
        "progressive": bool(hdr[9]),
        "adobe_transform": int(hdr[10]) - 1 if hdr[10] else None,
        "y": y,
        "cb": cb,
        "cr": cr,
        "qtab_luma_zz": ql,
        "qtab_chroma_zz": qc,
    }


def jpeg_scan_stats_progressive(
    width: int,
    height: int,
    subsampling: str,
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
) -> dict:
    """Progressive (SOF2 spectral-selection) analog of jpeg_scan_stats:
    2 DC + 3 AC table-class histograms (Y low band / chroma / Y high band),
    total entropy bytes over the 5 scans, and total stuffed bytes."""
    lib = _load()
    if lib is None or not hasattr(lib, "ce_jpeg_scan_stats_progressive"):
        raise RuntimeError(
            "native JPEG scan stats unavailable; build with `make -C native`"
        )
    y = np.ascontiguousarray(y_coeffs, dtype=np.int16)
    cb = np.ascontiguousarray(cb_coeffs, dtype=np.int16)
    cr = np.ascontiguousarray(cr_coeffs, dtype=np.int16)
    dc_freq = np.zeros((2, 256), dtype=np.uint32)
    ac_freq = np.zeros((3, 256), dtype=np.uint32)
    cap = 2 * (y.nbytes + cb.nbytes + cr.nbytes) + (1 << 16)
    scratch = np.empty(cap, dtype=np.uint8)
    scan_bytes = ctypes.c_int64()
    stuffed = ctypes.c_int64()
    sub_code = {"444": 0, "420": 1, "422": 2, "440": 3}[subsampling]
    rc = lib.ce_jpeg_scan_stats_progressive(
        width, height, sub_code,
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        y.shape[0], y.shape[1], cb.shape[0], cb.shape[1],
        dc_freq.ctypes.data, ac_freq.ctypes.data,
        scratch.ctypes.data, cap,
        ctypes.byref(scan_bytes), ctypes.byref(stuffed),
    )
    if rc != 0:
        raise RuntimeError("jpeg progressive scan stats failed (buffer/args)")
    return {
        "dc_freq": dc_freq,
        "ac_freq": ac_freq,
        "scan_bytes": int(scan_bytes.value),
        "stuffed": int(stuffed.value),
    }


def read_ppm(path) -> np.ndarray:
    lib = _load()
    if lib:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        rc = lib.ce_read_ppm(str(path).encode(), None, 0, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"ce_read_ppm header failed ({rc}) for {path}")
        out = np.empty((h.value, w.value, 3), dtype=np.uint8)
        rc = lib.ce_read_ppm(
            str(path).encode(), out.ctypes.data, out.nbytes,
            ctypes.byref(w), ctypes.byref(h),
        )
        if rc != 0:
            raise IOError(f"ce_read_ppm failed ({rc}) for {path}")
        return out
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise IOError(f"not a P6 PPM: {path}")
        dims = f.readline().split()
        w_, h_ = int(dims[0]), int(dims[1])
        maxval = int(f.readline())
        assert maxval == 255
        data = np.frombuffer(f.read(w_ * h_ * 3), dtype=np.uint8)
        return data.reshape(h_, w_, 3).copy()


def trellis_quantize_native(
    dct_zz: np.ndarray,
    q_zz: np.ndarray,
    ac_lengths: np.ndarray,
    lmbda: float,
) -> "Optional[np.ndarray]":
    """C++ trellis DP (native/jpeg_trellis.cpp), an exact mirror of
    kernels/jpeg_enc.trellis_quantize_blocks' numpy path.  Returns None
    when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "ce_trellis_quantize"):
        return None
    lead = dct_zz.shape[:-1]
    flat = np.ascontiguousarray(dct_zz.reshape(-1, 64), dtype=np.float32)
    q = np.ascontiguousarray(q_zz, dtype=np.float32)
    lengths = np.ascontiguousarray(ac_lengths, dtype=np.float32)
    assert q.shape == (64,) and lengths.shape == (16, 11)
    out = np.empty_like(flat, dtype=np.int16)
    rc = lib.ce_trellis_quantize(
        flat.ctypes.data, flat.shape[0], q.ctypes.data,
        lengths.ctypes.data, ctypes.c_float(float(lmbda)), out.ctypes.data,
    )
    if rc != 0:  # pragma: no cover - no failing path today
        return None
    return out.reshape(*lead, 64)
