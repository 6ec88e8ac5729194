"""EvalSession: the core callback-based evaluation engine.

Behavioral port of the reference's engine (reference:
src/eval/session.rs:280-585) with a device-first inner loop: codecs remain
opaque host-side callbacks (the reference's key architectural contract,
src/eval/session.rs:181-186), but metric scoring is *batched* — all decoded
candidates of an image are staged into one padded device batch and scored in
a single fused dispatch (see ``scoring.BatchScorer``) instead of pair-by-pair
native calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..errors import CodecError, CodecEvalError, DimensionMismatch
from ..metrics import MetricConfig
from ..viewing import ViewingCondition
from .image import ImageData
from .report import CodecResult, CorpusReport, ImageReport, write_csv_summary, write_json
from .scoring import BatchScorer

#: Encode callback: (ImageData, EncodeRequest) -> bytes
EncodeFn = Callable[["ImageData", "EncodeRequest"], bytes]
#: Decode callback: bytes -> ImageData
DecodeFn = Callable[[bytes], "ImageData"]

DEFAULT_QUALITY_LEVELS = [50.0, 60.0, 70.0, 80.0, 85.0, 90.0, 95.0]


@dataclass
class EncodeRequest:
    """Quality + codec-specific params.  reference: src/eval/session.rs:150-178."""

    quality: float
    params: Dict[str, str] = field(default_factory=dict)

    def with_param(self, key: str, value: str) -> "EncodeRequest":
        self.params[key] = value
        return self


@dataclass
class EvalConfig:
    """Session configuration.  reference: src/eval/session.rs:188-278."""

    report_dir: Path
    cache_dir: Optional[Path] = None
    viewing: ViewingCondition = field(default_factory=ViewingCondition.desktop)
    metrics: MetricConfig = field(default_factory=MetricConfig.all)
    quality_levels: List[float] = field(default_factory=lambda: list(DEFAULT_QUALITY_LEVELS))
    #: Byte sizes on the device-sweep fast path: "exact" entropy-codes
    #: fetched coefficients on host; "device" derives them from on-device
    #: rate statistics (kernels/jpeg_rate.py — entropy-exact, 0xFF
    #: stuffing estimated to ~±0.15%, no coefficient fetch).  Forced back
    #: to "exact" when cache_dir needs the artifact bytes anyway.
    device_size_mode: str = "exact"

    def __post_init__(self) -> None:
        # Validate on every construction path (builder, registry, direct) —
        # codecs silently clamp out-of-range qualities otherwise.
        from ..errors import InvalidQuality

        for q in self.quality_levels:
            if not 0.0 <= q <= 100.0:
                raise InvalidQuality(q)
        if self.device_size_mode not in ("exact", "device"):
            raise ValueError(
                f"device_size_mode must be 'exact' or 'device', "
                f"got {self.device_size_mode!r}"
            )

    @classmethod
    def builder(cls) -> "EvalConfigBuilder":
        return EvalConfigBuilder()


class EvalConfigBuilder:
    """Builder with the reference's defaulting rules (report_dir required)."""

    def __init__(self) -> None:
        self._report_dir: Optional[Path] = None
        self._cache_dir: Optional[Path] = None
        self._viewing: Optional[ViewingCondition] = None
        self._metrics: Optional[MetricConfig] = None
        self._quality_levels: Optional[List[float]] = None
        self._device_size_mode: str = "exact"

    def report_dir(self, path) -> "EvalConfigBuilder":
        self._report_dir = Path(path)
        return self

    def cache_dir(self, path) -> "EvalConfigBuilder":
        self._cache_dir = Path(path)
        return self

    def viewing(self, viewing: ViewingCondition) -> "EvalConfigBuilder":
        self._viewing = viewing
        return self

    def metrics(self, metrics: MetricConfig) -> "EvalConfigBuilder":
        self._metrics = metrics
        return self

    def quality_levels(self, levels: List[float]) -> "EvalConfigBuilder":
        self._quality_levels = [float(q) for q in levels]
        return self

    def device_size_mode(self, mode: str) -> "EvalConfigBuilder":
        """Byte sizes on the device-sweep fast path: "exact" (host entropy
        coder) or "device" (on-device rate statistics; entropy-exact,
        stuffing estimated ~±0.15%, no coefficient fetch)."""
        self._device_size_mode = mode
        return self

    def build(self) -> EvalConfig:
        if self._report_dir is None:
            raise ValueError("report_dir is required")
        # Quality-range validation lives in EvalConfig.__post_init__ (one
        # site for every construction path).
        return EvalConfig(
            report_dir=self._report_dir,
            cache_dir=self._cache_dir,
            viewing=self._viewing or ViewingCondition.desktop(),
            metrics=self._metrics or MetricConfig.all(),
            quality_levels=self._quality_levels or list(DEFAULT_QUALITY_LEVELS),
            device_size_mode=self._device_size_mode,
        )


@dataclass
class _CodecEntry:
    id: str
    version: str
    encode: EncodeFn
    decode: Optional[DecodeFn]
    #: Optional rich adapter (codecs.base.CodecImpl).  When it exposes a
    #: ``device_sweep`` capability (tpujpeg), the session fuses the whole
    #: (codec x quality) ladder — encode, decode, scoring — on device.
    impl: Optional[object] = None


class EvalSession:
    """The main evaluation engine.  reference: src/eval/session.rs:309-497.

    Codecs are registered as plain callables, making tests trivial (the
    reference's key testability property — closures instead of codec mocks,
    SURVEY.md §4.4).
    """

    def __init__(self, config: EvalConfig):
        self.config = config
        self._codecs: List[_CodecEntry] = []
        self._scorer = BatchScorer(config.metrics)
        #: Device-fast-path observability: fallbacks are survivable by
        #: design, but silent ones would hide real defects.
        self.device_sweeps_run = 0
        self.device_sweep_fallbacks = 0
        self.jpeg_device_decodes_run = 0
        self.jpeg_device_decode_fallbacks = 0

    def add_codec(self, codec_id: str, version: str, encode: EncodeFn) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, None))
        return self

    def add_codec_with_decode(
        self, codec_id: str, version: str, encode: EncodeFn, decode: DecodeFn
    ) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, decode))
        return self

    def add_codec_impl(self, codec) -> "EvalSession":
        """Register a CodecImpl adapter.  Equivalent to
        add_codec_with_decode, but keeps the adapter object so codecs with
        a device-resident ladder path (tpujpeg's ``device_sweep``) are
        evaluated without their candidates round-tripping through host
        RAM."""
        self._codecs.append(
            _CodecEntry(
                codec.id(), codec.version(), codec.encode_fn(),
                codec.decode_fn(), impl=codec,
            )
        )
        return self

    @property
    def codec_count(self) -> int:
        return len(self._codecs)

    def _stage_cell(
        self,
        name: str,
        image: ImageData,
        codec: _CodecEntry,
        quality: float,
        keep_bytes: bool = False,
        decode: bool = True,
    ) -> dict:
        """Host phase for one (codec, quality) cell: encode/decode, timed.
        reference timers: src/eval/session.rs:380-389."""
        width, height = image.width, image.height
        request = EncodeRequest(quality=quality)
        t0 = time.perf_counter()
        # Callback boundary: arbitrary third-party exceptions become typed
        # CodecError, the way the reference's EncodeFn signature forces
        # callback failures into Error::Codec (src/eval/session.rs:181-186)
        # — so the per-cell skip-and-continue policy applies to them.
        try:
            encoded = codec.encode(image, request)
        except CodecEvalError:
            raise
        except Exception as e:  # noqa: BLE001 - callback boundary
            raise CodecError(
                codec.id, f"encode failed at q{quality:g}: {type(e).__name__}: {e}"
            ) from e
        encode_ms = int((time.perf_counter() - t0) * 1000)

        cached_path = None
        if self.config.cache_dir is not None:
            # Encoded-artifact caching (the reference plumbs
            # cache_dir but never writes it — closed here).
            self.config.cache_dir.mkdir(parents=True, exist_ok=True)
            cached = self.config.cache_dir / (
                f"{name}-{codec.id}-q{quality:g}.bin"
            )
            cached.write_bytes(encoded)
            cached_path = str(cached)

        entry = {
            "codec": codec,
            "quality": quality,
            "params": request.params,
            "file_size": len(encoded),
            "encode_ms": encode_ms,
            "decode_ms": None,
            "decoded": None,
            "cached_path": cached_path,
            "error": None,
        }
        if keep_bytes:
            entry["data"] = encoded
        if codec.decode is not None and decode:
            t0 = time.perf_counter()
            try:
                decoded = codec.decode(encoded)
            except CodecEvalError:
                raise
            except Exception as e:  # noqa: BLE001 - callback boundary
                raise CodecError(
                    codec.id, f"decode failed at q{quality:g}: {type(e).__name__}: {e}"
                ) from e
            entry["decode_ms"] = int((time.perf_counter() - t0) * 1000)
            decoded_rgb = decoded.to_rgb8_srgb()
            if decoded_rgb.shape[:2] != (height, width):
                raise DimensionMismatch(
                    (width, height),
                    (decoded_rgb.shape[1], decoded_rgb.shape[0]),
                )
            entry["decoded"] = decoded_rgb
        return entry

    def _stage_image(
        self, name: str, image: ImageData, on_error: str = "raise"
    ) -> List[dict]:
        """Host phase: run every (codec, quality) encode/decode cell.

        With ``on_error="skip"``, a failing cell is recorded with
        ``error`` set and unscored (None) metrics while the remaining
        (codec, quality) cells still run — the reference's per-eval
        continue policy (reference: crates/codec-compare/src/main.rs:374-376
        keeps iterating; metrics are Option-valued per cell)."""
        from ..errors import CodecEvalError

        staged: List[dict] = []
        for codec in self._codecs:
            if self._device_sweep_ok(codec):
                try:
                    staged.extend(self._stage_codec_device(name, image, codec))
                    self.device_sweeps_run += 1
                    continue
                except Exception as e:  # noqa: BLE001 - fall back, loudly
                    import warnings

                    self.device_sweep_fallbacks += 1
                    warnings.warn(
                        f"device sweep failed for {codec.id} "
                        f"({type(e).__name__}: {e}); using the host "
                        "per-cell path",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            if self._jpeg_device_ok(codec):
                try:
                    staged.extend(
                        self._stage_codec_jpeg_device(name, image, codec)
                    )
                    self.jpeg_device_decodes_run += 1
                    continue
                except Exception as e:  # noqa: BLE001 - fall back, loudly
                    import warnings

                    self.jpeg_device_decode_fallbacks += 1
                    warnings.warn(
                        f"device JPEG decode failed for {codec.id} "
                        f"({type(e).__name__}: {e}); using the host "
                        "per-cell path",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            for quality in self.config.quality_levels:
                try:
                    staged.append(self._stage_cell(name, image, codec, quality))
                except CodecEvalError as e:
                    if on_error != "skip":
                        raise
                    staged.append(
                        {
                            "codec": codec,
                            "quality": quality,
                            "params": {},
                            "file_size": 0,
                            "encode_ms": 0,
                            "decode_ms": None,
                            "decoded": None,
                            "cached_path": None,
                            "error": str(e),
                        }
                    )
        return staged

    def _device_sweep_ok(self, codec: _CodecEntry) -> bool:
        m = self.config.metrics
        return (
            codec.impl is not None
            and hasattr(codec.impl, "device_sweep")
            and getattr(codec.impl, "supports_device_sweep", lambda: True)()
            and not m.xyb_roundtrip
            and (m.dssim or m.ssimulacra2 or m.butteraugli or m.psnr)
        )

    def _jpeg_device_ok(self, codec: _CodecEntry) -> bool:
        """Adapter-registered codecs that emit standard JPEG streams can
        decode and score on device (codecs/jpeg_device.py): the host runs
        only the Huffman parse and the decoded candidates never visit
        host RAM.  Gated exactly like the device sweep; callback-registered
        codecs never qualify (their decode semantics are opaque)."""
        m = self.config.metrics
        if (
            codec.impl is None
            or codec.decode is None
            or m.xyb_roundtrip
            or not (m.dssim or m.ssimulacra2 or m.butteraugli or m.psnr)
        ):
            return False
        try:
            if codec.impl.format() != "jpg":
                return False
        except Exception:  # noqa: BLE001 - capability probe only
            return False
        from ..codecs import jpeg_device

        return jpeg_device.is_available()

    def _stage_codec_jpeg_device(
        self, name: str, image: ImageData, codec: _CodecEntry
    ) -> List[dict]:
        """JPEG-bytes fast path: encode every quality on host (timed per
        cell), then one device-decode + one fused scoring batch for the
        whole ladder.  decode_ms carries each cell's share of the batch
        wall time."""
        from ..codecs.jpeg_device import score_jpeg_files
        from ..metrics import MetricResult

        m = self.config.metrics
        wanted = tuple(
            k
            for k, on in (
                ("dssim", m.dssim),
                ("ssimulacra2", m.ssimulacra2),
                ("butteraugli", m.butteraugli),
                ("psnr", m.psnr),
            )
            if on
        )
        entries = [
            self._stage_cell(
                name, image, codec, q, keep_bytes=True, decode=False
            )
            for q in self.config.quality_levels
        ]
        t0 = time.perf_counter()
        scores = score_jpeg_files(
            image.to_rgb8(), [e["data"] for e in entries], metrics=wanted
        )
        per_cell_ms = int(
            (time.perf_counter() - t0) * 1000 / max(len(entries), 1)
        )
        for e, s in zip(entries, scores):
            e.pop("data", None)
            e["metrics"] = MetricResult(**{k: s.get(k) for k in wanted})
            e["scored"] = True
            e["decode_ms"] = per_cell_ms
        return entries

    def _stage_codec_device(
        self, name: str, image: ImageData, codec: _CodecEntry
    ) -> List[dict]:
        """Device ladder for one codec: encode transform, decode
        reconstruction, and scoring fused on device (engine/tpu_sweep.py);
        the host entropy pass supplies exact byte sizes (and the artifact
        bytes when cache_dir is set).  encode_ms carries each cell's share
        of the measured ladder wall time; decode_ms is 0 because no host
        decode happens — the reconstruction is part of the same device
        program."""
        from ..metrics import MetricResult

        m = self.config.metrics
        wanted = tuple(
            k
            for k, on in (
                ("dssim", m.dssim),
                ("ssimulacra2", m.ssimulacra2),
                ("butteraugli", m.butteraugli),
                ("psnr", m.psnr),
            )
            if on
        )
        want_bytes = self.config.cache_dir is not None
        t0 = time.perf_counter()
        points = codec.impl.device_sweep(
            image, list(self.config.quality_levels), wanted,
            with_bytes=want_bytes,
            size_mode=self.config.device_size_mode,
        )
        per_cell_ms = int(
            (time.perf_counter() - t0) * 1000 / max(len(points), 1)
        )
        staged = []
        for p in points:
            cached_path = None
            if want_bytes and p.data is not None:
                self.config.cache_dir.mkdir(parents=True, exist_ok=True)
                cached = self.config.cache_dir / (
                    f"{name}-{codec.id}-q{p.quality:g}.bin"
                )
                cached.write_bytes(p.data)
                cached_path = str(cached)
            staged.append(
                {
                    "codec": codec,
                    "quality": p.quality,
                    "params": {},
                    "file_size": p.file_size or 0,
                    "encode_ms": per_cell_ms,
                    "decode_ms": 0,
                    "decoded": None,
                    "cached_path": cached_path,
                    "error": None,
                    "metrics": MetricResult(**{k: p.metrics.get(k) for k in wanted}),
                    "scored": True,
                }
            )
        return staged

    def _score_and_report(
        self, name: str, image: ImageData, staged: List[dict]
    ) -> ImageReport:
        """Device phase: one fused batch for all decodable pairs."""
        width, height = image.width, image.height
        report = ImageReport(name=name, width=width, height=height)
        reference_rgb = image.to_rgb8()

        decodable = [
            e for e in staged if e["decoded"] is not None and "metrics" not in e
        ]
        if decodable and self._scorer.enabled():
            batch = np.stack([e["decoded"] for e in decodable])
            results = self._scorer.score_batch(reference_rgb, batch)
            for e, m in zip(decodable, results):
                e["metrics"] = m

        from ..metrics import MetricResult

        for e in staged:
            metrics = e.get("metrics", MetricResult())
            report.results.append(
                CodecResult(
                    codec_id=e["codec"].id,
                    codec_version=e["codec"].version,
                    quality=e["quality"],
                    file_size=e["file_size"],
                    bits_per_pixel=e["file_size"] * 8 / (width * height),
                    encode_time_ms=e["encode_ms"],
                    decode_time_ms=e["decode_ms"],
                    metrics=metrics,
                    perception=(
                        metrics.perception_level()
                        if (e["decoded"] is not None or e.get("scored"))
                        else None
                    ),
                    cached_path=e["cached_path"],
                    codec_params=e["params"],
                )
            )
        return report

    def evaluate_image(
        self, name: str, image: ImageData, on_error: str = "raise"
    ) -> ImageReport:
        """Evaluate one image across all codecs x quality levels.

        Host codecs run serially (timed individually); all decoded
        candidates are then scored in one batched device dispatch.
        ``on_error="skip"`` keeps per-cell failures as unscored rows.
        """
        return self._score_and_report(
            name, image, self._stage_image(name, image, on_error=on_error)
        )

    def evaluate_corpus(
        self, images, name: str = "corpus", on_error: str = "skip", progress=None
    ) -> CorpusReport:
        """Evaluate an iterable of (name, ImageData) pairs with a one-slot
        host/device pipeline: host codecs encode image i+1 while the device
        scores image i (the infeed overlap replacing the reference's rayon
        fan-out).  ``on_error="skip"`` applies the reference's
        skip-and-continue failure policy; "raise" propagates.
        """
        from concurrent.futures import ThreadPoolExecutor

        from ..errors import CodecEvalError

        items = list(images)
        corpus_report = CorpusReport(name=name)
        if not items:
            return corpus_report

        def stage(idx):
            img_name, image = items[idx]
            # Per-cell failures become unscored rows under "skip"; only
            # image-level failures (unreadable source, every cell failing
            # to even construct) propagate to the image-skip policy below.
            return self._stage_image(img_name, image, on_error=on_error)

        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(stage, 0)
            for i, (img_name, image) in enumerate(items):
                try:
                    staged = future.result()
                except CodecEvalError as e:
                    if on_error == "raise":
                        raise
                    if progress:
                        progress(f"SKIP {img_name} ({e})")
                    staged = None
                if i + 1 < len(items):
                    future = pool.submit(stage, i + 1)
                if staged is None:
                    continue
                report = self._score_and_report(img_name, image, staged)
                corpus_report.images.append(report)
                if progress:
                    progress(f"[{i + 1}/{len(items)}] {img_name} OK")
        return corpus_report

    def write_image_report(self, report: ImageReport) -> None:
        """JSON report at <report_dir>/<name>.json.
        reference: src/eval/session.rs:500-508."""
        self.config.report_dir.mkdir(parents=True, exist_ok=True)
        write_json(report, self.config.report_dir / f"{report.name}.json")

    def write_corpus_report(self, report: CorpusReport) -> None:
        """JSON + 13-column CSV summary.  reference: src/eval/session.rs:511-584."""
        self.config.report_dir.mkdir(parents=True, exist_ok=True)
        write_json(report, self.config.report_dir / f"{report.name}.json")
        write_csv_summary(report, self.config.report_dir / f"{report.name}.csv")
