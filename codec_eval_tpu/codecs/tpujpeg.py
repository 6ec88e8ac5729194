"""tpujpeg: the device-side jpegli-style JPEG encoder adapter.

Fills the role the reference gives its zenjpeg crate — a self-built,
jpegli-style pure-software JPEG encoder in the comparison ladder
(reference: crates/codec-compare/src/encoders/zenjpeg.rs:10-58,
crates/codec-iter/src/config.rs:5-67).  Architecture is device-first rather
than a translation: the quality-independent analysis (YCbCr, subsampling,
all 8x8 forward DCTs as batched matmuls, the psychovisual activity
field) runs as one jitted device program per image
(kernels/jpeg_enc.build_transform); per-quality work is a cheap host
quantization pass plus the native C++ optimized-Huffman entropy coder
(native/jpeg_entropy.cpp).

jpegli-style techniques carried over (re-derived, not transcribed —
jpegli itself is not present in this environment):

- **Adaptive quantization via rounding bias**: quantization tables stay
  global (standard-decodable), but the rounding offset of AC coefficients
  narrows from 0.5 (round-to-nearest) toward a wider zero deadzone in
  blocks whose activity field says texture masking hides the loss.
- **Optimized Huffman tables always** (two-pass histogram -> canonical
  length-limited codes).
- **Quality sweeps share one analysis pass**: ``encode_sweep`` encodes all
  quality levels of an image from a single device transform — the encoder
  analog of the scorer's reference-precompute reuse
  (reference precedent: crates/codec-iter/src/eval.rs:138-149).

- **Trellis quantization** (``trellis=True``): rate-distortion-optimal AC
  coefficient selection by dynamic program (kernels/jpeg_enc.py
  ``trellis_quantize_blocks``; hot loop in C++, native/jpeg_trellis.cpp,
  ~26 ms/quality at 512px) — the standard-decodable technique the
  reference's AVIF ladder names a preset after (qm-trellis,
  crates/codec-iter/src/avif_config.rs:33-68).  Replaces the AQ bias.

Measured ladder position (tools/tpujpeg_bench.py --clean, 2026-08-18,
BD-rate vs PIL libjpeg-turbo 4:2:0 optimized, q50-95, 8x 512px noise-free
synthetic photos — gradients, hard edges, smooth texture;
SSIMULACRA2 / Butteraugli):

    plain tpujpeg-420        -4.6% / -1.2%
    tpujpeg-420-aq (0.30)   -20.6% / -27.6%
    tpujpeg-420-trellis     -24.1% / -25.6%   (lambda = 0.10, the default)

The trellis lambda sweep is two-sided: larger lambda keeps improving
SSIMULACRA2 (-27.8% at 0.20) while degrading Butteraugli (-16.5% at 0.20,
+4.3% at 0.40) — it starts deleting texture SSIMULACRA2 underweights.
lambda=0.10 is the calibrated default (both metrics within ~2pt of their
optima).  In XYB mode (same protocol, vs PIL 4:4:4 optimized) trellis
compounds with the colorspace: xyb plain -27.7% s2 / -46.0% ba, xyb-aq
-41.6%/-58.8%, xyb-trellis -45.2%/-59.3% at the same lambda=0.10 — the
flattened XYB tables leave many near-zero AC coefficients the DP prices
out.  On noisy content every deadzone-family number is inflated (the
zeroing deletes exactly the sensor noise perceptual metrics barely
score); clean-corpus figures are the representative ones.
aq_strength=0.30 stays the AQ default from the same scan protocol.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.image import ImageData
from ..engine.session import EncodeRequest
from ..errors import CodecError, CodecEvalError
from ..kernels import jpeg_enc as _je
from ..utils import native as _native
from .base import CodecImpl

__all__ = ["TpuJpegCodec", "is_available"]


def is_available() -> bool:
    """True when the native entropy coder is present (auto-built on first
    use when a toolchain exists; see utils/native._try_build)."""
    return _native.jpeg_entropy_available()


class TpuJpegCodec(CodecImpl):
    """jpegli-style baseline JPEG encoder with a device transform path.

    Parameters
    ----------
    subsampling: "420" (default), "444", "422", or "440".
    adaptive: enable the activity-driven rounding bias (default True;
        forced off by ``trellis``, which replaces it).
    aq_strength: maximum reduction of the AC rounding offset at full
        activity; 0.30 means busy blocks round with offset 0.5 - 0.30.
        Calibrated by tools/tpujpeg_bench.py.
    trellis: rate-distortion-optimal AC selection (baseline mode only).
    trellis_lambda: bits-vs-distortion tradeoff of the trellis DP, in
        (quantizer-step)^2 per bit.  0.10 calibrated by
        tools/tpujpeg_bench.py --trellis-scan --clean.
    """

    def __init__(
        self,
        subsampling: str = "420",
        adaptive: bool = True,
        aq_strength: float = 0.30,
        colorspace: str = "ycbcr",
        progressive: bool = False,
        trellis: bool = False,
        trellis_lambda: float = 0.10,
    ):
        if subsampling not in ("420", "444", "422", "440"):
            raise CodecError("tpujpeg", f"unsupported subsampling {subsampling!r}")
        if colorspace not in ("ycbcr", "xyb"):
            raise CodecError("tpujpeg", f"unsupported colorspace {colorspace!r}")
        if colorspace == "xyb":
            subsampling = "444"  # XYB mode is 4:4:4 only
        if trellis and progressive:
            # The trellis rate model is the baseline (run, size) alphabet;
            # progressive scans code a different symbol stream.
            raise CodecError("tpujpeg", "trellis requires baseline mode")
        if trellis:
            # Trellis replaces the AQ rounding bias; activity-modulated
            # lambda was measured strictly worse at every lambda
            # (tools/tpujpeg_bench.py --trellis-scan, 2026-08-18): the DP
            # already prices busy blocks through their symbol costs, so
            # scaling lambda by activity double-counts masking.
            adaptive = False
        self.subsampling = subsampling
        self.adaptive = adaptive
        self.aq_strength = float(aq_strength)
        self.colorspace = colorspace
        self.progressive = bool(progressive)
        self.trellis = bool(trellis)
        self.trellis_lambda = float(trellis_lambda)
        # One-slot transform memo: the session sweeps qualities per image,
        # so consecutive encode() calls see the same pixels (keyed by FNV
        # of the raw bytes to stay correct if they do not).
        self._memo_lock = threading.Lock()
        self._memo_key: Optional[Tuple[int, int, int]] = None
        self._memo_val: Optional[Dict[str, np.ndarray]] = None

    # -- CodecImpl ----------------------------------------------------------

    def id(self) -> str:
        aq = "-aq" if self.adaptive else ""
        prog = "-prog" if self.progressive else ""
        tre = "-trellis" if self.trellis else ""
        if self.colorspace == "xyb":
            return f"tpujpeg-xyb{aq}{tre}{prog}"
        return f"tpujpeg-{self.subsampling}{aq}{tre}{prog}"

    def version(self) -> str:
        return "1.0"

    def format(self) -> str:
        return "jpg"

    def is_available(self) -> bool:
        return is_available()

    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        rgb = image.to_rgb8()
        tr = self._transform(rgb)
        return self._encode_from_transform(
            tr, rgb.shape[1], rgb.shape[0], float(request.quality)
        )

    def decode(self, data: bytes) -> ImageData:
        # Device decode path: host entropy parse + device dequant/iDCT/
        # fancy-upsample (codecs/jpeg_device.py) — one code path for both
        # the YCbCr and XYB (Adobe transform-0) containers.
        from .jpeg_device import decode_jpeg_device, is_available

        if is_available():
            try:
                return ImageData.rgb8(decode_jpeg_device(data))
            except (ValueError, CodecEvalError) as exc:
                raise CodecError(self.id(), f"decode failed: {exc}") from exc

        from PIL import Image

        try:
            img = Image.open(io.BytesIO(data)).convert("RGB")
        except Exception as exc:  # pragma: no cover - PIL error taxonomy
            raise CodecError(self.id(), f"decode failed: {exc}") from exc
        arr = np.asarray(img)
        if self.colorspace == "xyb":
            # Adobe transform-0 passthrough: channels are [0,255]-scaled
            # (Y, X, B); invert on device (the exact reconstruct path).
            import jax.numpy as jnp

            from ..kernels.jpeg_enc import _scaled_xyb_to_rgb_u8

            planes = arr.astype(np.float32)
            arr = np.asarray(
                _scaled_xyb_to_rgb_u8(
                    jnp.asarray(planes[..., 0]),
                    jnp.asarray(planes[..., 1]),
                    jnp.asarray(planes[..., 2]),
                )
            )
        return ImageData.rgb8(arr)

    # -- sweep API ----------------------------------------------------------

    def encode_sweep(
        self, image: ImageData, qualities: Sequence[float]
    ) -> List[bytes]:
        """Encode every quality level from ONE device analysis pass."""
        rgb = image.to_rgb8()
        tr = self._transform(rgb)
        w, h = rgb.shape[1], rgb.shape[0]
        return [self._encode_from_transform(tr, w, h, float(q)) for q in qualities]

    def device_sweep(
        self,
        image: ImageData,
        qualities: Sequence[float],
        metrics: Sequence[str],
        with_bytes: bool = False,
        size_mode: str = "exact",
    ):
        """Whole-ladder device evaluation (engine/tpu_sweep.py) with this
        codec's exact settings — the capability hook EvalSession uses to
        fuse encode/decode/score on device for tpujpeg codecs.  Trellis
        runs as a device DP (kernels/jpeg_enc.trellis_quantize_dev).
        size_mode="device" derives byte sizes from on-device rate
        statistics instead of the host entropy coder (ignored when the
        artifact bytes are needed)."""
        from ..engine.tpu_sweep import evaluate_tpujpeg_sweep

        return evaluate_tpujpeg_sweep(
            image.to_rgb8(),
            qualities,
            subsampling=self.subsampling,
            aq_strength=self.aq_strength if self.adaptive else 0.0,
            metrics=metrics,
            colorspace=self.colorspace,
            progressive=self.progressive,
            return_bytes=with_bytes,
            trellis_lambda=self.trellis_lambda if self.trellis else 0.0,
            with_sizes="device" if size_mode == "device" else True,
        )

    # -- internals ----------------------------------------------------------

    def _transform(self, rgb: np.ndarray) -> Dict[str, np.ndarray]:
        key = (_native.fnv1a64(rgb), rgb.shape[0], rgb.shape[1])
        with self._memo_lock:
            if key == self._memo_key and self._memo_val is not None:
                return self._memo_val
        val = _je.jpeg_transform(rgb, self.subsampling, self.colorspace)
        with self._memo_lock:
            self._memo_key, self._memo_val = key, val
        return val

    def _qtables(self, quality: float):
        if self.colorspace == "xyb":
            return _je.quality_to_qtables(
                quality, _je.XYB_LUMA_BASE, _je.XYB_CHROMA_BASE
            )
        return _je.quality_to_qtables(quality)

    def _bias(self, act: np.ndarray) -> np.ndarray | float:
        if not self.adaptive:
            return 0.5
        return np.clip(0.5 - self.aq_strength * act, 0.2, 0.5).astype(np.float32)

    def _encode_from_transform(
        self, tr: Dict[str, np.ndarray], width: int, height: int, quality: float
    ) -> bytes:
        ql, qc = self._qtables(quality)
        if self.trellis:
            # Rate model: the static corpus-fitted tables shared with the
            # device DP (DEFAULT_AC_LENGTHS_*) — per-image Huffman fitting
            # measured worth 0.01 BD-rate points (tools/fit_rate_tables.py),
            # and one model keeps host and device decisions aligned.
            lam = self.trellis_lambda
            qy = _je.trellis_quantize_blocks(
                tr["dct_y"], ql, _je.DEFAULT_AC_LENGTHS_LUMA, lam
            )
            qcb = _je.trellis_quantize_blocks(
                tr["dct_cb"], qc, _je.DEFAULT_AC_LENGTHS_CHROMA, lam
            )
            qcr = _je.trellis_quantize_blocks(
                tr["dct_cr"], qc, _je.DEFAULT_AC_LENGTHS_CHROMA, lam
            )
        else:
            qy = _je.quantize_blocks(tr["dct_y"], ql, self._bias(tr["act_y"]))
            qcb = _je.quantize_blocks(tr["dct_cb"], qc, self._bias(tr["act_c"]))
            qcr = _je.quantize_blocks(tr["dct_cr"], qc, self._bias(tr["act_c"]))
        return _native.jpeg_encode_baseline(
            width, height, self.subsampling,
            qy, qcb, qcr, ql[_je.ZIGZAG], qc[_je.ZIGZAG],
            app_mode=1 if self.colorspace == "xyb" else 0,
            progressive=self.progressive,
        )

    @classmethod
    def presets(cls) -> List["TpuJpegCodec"]:
        """The tpujpeg ladder (the zenjpeg config grid analog,
        reference: crates/codec-iter/src/config.rs:5-67)."""
        return [
            cls(subsampling="420", adaptive=True),
            cls(subsampling="444", adaptive=True),
            cls(subsampling="420", adaptive=False),
            cls(subsampling="444", adaptive=False),
            cls(colorspace="xyb", adaptive=True),
            cls(subsampling="420", adaptive=True, progressive=True),
            cls(subsampling="420", trellis=True),
            cls(colorspace="xyb", trellis=True),
        ]
