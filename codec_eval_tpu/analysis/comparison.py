"""Corpus-scale codec comparison studies.

Capability ports of the reference's analysis binaries
(crates/codec-compare/src/{full_comparison,brute_force_sweep,find_outliers,
rd_compare}.rs):

- ``full_comparison``: two codecs swept across a quality range, all metrics,
  CSV rows per (image, codec, quality).
- ``brute_force_sweep``: codecs x fine quality grid (0..100 step 2) for
  metric-correlation studies, with a live ETA display.
- ``find_outliers``: images where the A<->B advantage diverges most from the
  corpus mean (per-image butteraugli advantage at matched qualities).
- ``rd_compare``: matched-bpp (not matched-quality) comparison at fixed bpp
  targets via per-image curve interpolation.

The hot loop everywhere is the same device pattern: one fused device batch per
(image, codec) scoring the whole quality sweep against the precomputed
reference — replacing the reference's rayon fan-out of per-pair SIMD calls.
"""

from __future__ import annotations

import csv
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..corpus import Corpus
from ..iter.eval import Codec
from ..stats.summary import mean


@dataclass
class ComparisonRow:
    image: str
    codec: str
    quality: int
    bpp: float
    ssimulacra2: float
    dssim: float
    butteraugli: float
    encode_ms: int


CSV_HEADER = [
    "image", "codec", "quality", "bpp", "ssimulacra2", "dssim",
    "butteraugli", "encode_ms",
]


def _score_sweep_fn():
    import jax
    import jax.numpy as jnp

    from ..kernels.butteraugli import (
        butteraugli_against_reference,
        precompute_butteraugli_reference,
    )
    from ..kernels.color import srgb_u8_to_linear
    from ..kernels.dssim import (
        dssim_against_reference,
        precompute_dssim_reference,
    )
    from ..kernels.ssimulacra2 import (
        features_against_reference,
        precompute_reference,
        score_from_features,
    )

    @jax.jit
    def score(ref_u8, batch_u8):
        # All three reference-side precomputes are shared across the sweep.
        pre = precompute_reference(ref_u8)
        s2 = jax.vmap(
            lambda d: score_from_features(features_against_reference(pre, d))
        )(batch_u8)
        dref = precompute_dssim_reference(srgb_u8_to_linear(ref_u8))
        ds = jax.vmap(
            lambda d: dssim_against_reference(dref, srgb_u8_to_linear(d))
        )(batch_u8)
        bref = precompute_butteraugli_reference(ref_u8)
        ba = jax.vmap(lambda d: butteraugli_against_reference(bref, d))(batch_u8)
        return s2, ds, ba

    return score


def sweep_codecs(
    corpus: Corpus,
    codecs: Sequence[Codec],
    qualities: Sequence[int],
    limit: int = 0,
    progress: Optional[Callable[[str], None]] = None,
    eta: bool = False,
    checkpoint: Optional[Path] = None,
) -> List[ComparisonRow]:
    """(image x codec x quality) grid, fully scored.

    ``checkpoint`` enables shard-level resume (a gap the reference leaves
    open — its interrupted sweeps restart from scratch, SURVEY.md §5):
    completed (image, codec) units append to a JSONL file and are skipped
    on rerun.
    """
    import jax.numpy as jnp
    from PIL import Image

    score = _score_sweep_fn()
    images = corpus.images[:limit] if limit else corpus.images
    total_units = len(images) * len(codecs)
    done = 0
    t0 = time.perf_counter()
    rows: List[ComparisonRow] = []

    completed = set()
    ckpt_fh = None
    if checkpoint is not None:
        checkpoint = Path(checkpoint)
        if checkpoint.exists():
            with open(checkpoint) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    completed.add((rec["image"], rec["codec"]))
                    for r in rec["rows"]:
                        rows.append(ComparisonRow(**r))
            if progress and completed:
                progress(f"resumed {len(completed)} completed units from {checkpoint}")
        ckpt_fh = open(checkpoint, "a")

    for corpus_image in images:
        path = corpus_image.full_path(corpus.root_path)
        try:
            rgb = np.asarray(Image.open(path).convert("RGB"))
        except Exception as e:  # noqa: BLE001 — skip-and-continue
            if progress:
                progress(f"SKIP {corpus_image.relative_path} ({e})")
            continue
        h, w = rgb.shape[:2]
        ref_dev = jnp.asarray(rgb)
        for codec in codecs:
            if (corpus_image.name(), codec.summary) in completed:
                done += 1
                continue
            entries = []
            for q in qualities:
                t_enc = time.perf_counter()
                data = codec.encode(rgb, int(q))
                enc_ms = int((time.perf_counter() - t_enc) * 1000)
                entries.append((int(q), len(data), enc_ms, codec.decode(data)))
            batch = np.stack([e[3] for e in entries])
            s2s, dss, bas = score(ref_dev, jnp.asarray(batch))
            unit_rows = []
            for (q, size, enc_ms, _), s2, ds, ba in zip(
                entries, np.asarray(s2s), np.asarray(dss), np.asarray(bas)
            ):
                unit_rows.append(
                    ComparisonRow(
                        image=corpus_image.name(),
                        codec=codec.summary,
                        quality=q,
                        bpp=size * 8.0 / (w * h),
                        ssimulacra2=float(s2),
                        dssim=float(ds),
                        butteraugli=float(ba),
                        encode_ms=enc_ms,
                    )
                )
            rows.extend(unit_rows)
            if ckpt_fh is not None:
                ckpt_fh.write(
                    json.dumps(
                        {
                            "image": corpus_image.name(),
                            "codec": codec.summary,
                            "rows": [r.__dict__ for r in unit_rows],
                        }
                    )
                    + "\n"
                )
                ckpt_fh.flush()
            done += 1
            if progress:
                msg = f"[{done}/{total_units}] {corpus_image.name()} x {codec.summary}"
                if eta and done > 1:
                    rate = (time.perf_counter() - t0) / done
                    msg += f"  ETA {rate * (total_units - done):.0f}s"
                progress(msg)
    if ckpt_fh is not None:
        ckpt_fh.close()
    return rows


def write_comparison_csv(rows: Sequence[ComparisonRow], path: Path) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for r in rows:
            w.writerow(
                [
                    r.image, r.codec, r.quality, f"{r.bpp:.4f}",
                    f"{r.ssimulacra2:.2f}", f"{r.dssim:.6f}",
                    f"{r.butteraugli:.4f}", r.encode_ms,
                ]
            )


def read_comparison_csv(path: Path) -> List[ComparisonRow]:
    rows = []
    with open(path, newline="") as f:
        for d in csv.DictReader(f):
            rows.append(
                ComparisonRow(
                    image=d["image"],
                    codec=d["codec"],
                    quality=int(float(d["quality"])),
                    bpp=float(d["bpp"]),
                    ssimulacra2=float(d["ssimulacra2"]),
                    dssim=float(d["dssim"]),
                    butteraugli=float(d["butteraugli"]),
                    encode_ms=int(float(d.get("encode_ms", 0) or 0)),
                )
            )
    return rows


# -- outliers -------------------------------------------------------------


@dataclass
class OutlierReport:
    """Per-image advantage of codec_b over codec_a (negative butteraugli
    delta = b is better), sorted by divergence from the corpus mean.
    reference: find_outliers.rs."""

    codec_a: str
    codec_b: str
    corpus_mean_advantage: float
    # (image, advantage, divergence)
    images: List[Tuple[str, float, float]] = field(default_factory=list)


def find_outliers(
    rows: Sequence[ComparisonRow], codec_a: str, codec_b: str, top_n: int = 10
) -> OutlierReport:
    by_image: Dict[str, Dict[str, List[Tuple[int, float]]]] = {}
    for r in rows:
        if r.codec in (codec_a, codec_b):
            by_image.setdefault(r.image, {}).setdefault(r.codec, []).append(
                (r.quality, r.butteraugli)
            )

    advantages: Dict[str, float] = {}
    for image, by_codec in by_image.items():
        if codec_a not in by_codec or codec_b not in by_codec:
            continue
        a = dict(by_codec[codec_a])
        b = dict(by_codec[codec_b])
        shared = sorted(set(a) & set(b))
        if not shared:
            continue
        # Advantage of b at matched qualities (lower butteraugli = better).
        advantages[image] = mean([a[q] - b[q] for q in shared])

    if not advantages:
        return OutlierReport(codec_a, codec_b, 0.0, [])
    corpus_mean = mean(list(advantages.values()))
    ranked = sorted(
        (
            (image, adv, abs(adv - corpus_mean))
            for image, adv in advantages.items()
        ),
        key=lambda t: -t[2],
    )
    return OutlierReport(codec_a, codec_b, corpus_mean, ranked[:top_n])


def outlier_report_json(report: OutlierReport) -> str:
    return json.dumps(
        {
            "codec_a": report.codec_a,
            "codec_b": report.codec_b,
            "corpus_mean_advantage": report.corpus_mean_advantage,
            "outliers": [
                {"image": i, "advantage": a, "divergence": d}
                for i, a, d in report.images
            ],
        },
        indent=2,
    )


# -- matched-bpp comparison ----------------------------------------------

DEFAULT_BPP_TARGETS = [0.5, 1.0, 1.5, 2.0, 3.0]


def _interp_at_bpp(
    curve: List[Tuple[float, float]], target: float
) -> Optional[float]:
    curve = sorted(curve)
    for (b0, v0), (b1, v1) in zip(curve, curve[1:]):
        if b0 <= target <= b1 and b1 - b0 > 1e-12:
            t = (target - b0) / (b1 - b0)
            return v0 + t * (v1 - v0)
    return None


@dataclass
class RdCompareResult:
    codec_a: str
    codec_b: str
    # target_bpp -> (mean_s2_a, mean_s2_b, n_images)
    by_target: Dict[float, Tuple[float, float, int]] = field(default_factory=dict)


def rd_compare(
    rows: Sequence[ComparisonRow],
    codec_a: str,
    codec_b: str,
    targets: Sequence[float] = tuple(DEFAULT_BPP_TARGETS),
) -> RdCompareResult:
    """Quality at matched bpp via per-image curve interpolation.
    reference: rd_compare.rs."""
    curves: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for r in rows:
        if r.codec in (codec_a, codec_b):
            curves.setdefault(r.image, {}).setdefault(r.codec, []).append(
                (r.bpp, r.ssimulacra2)
            )
    result = RdCompareResult(codec_a, codec_b)
    for target in targets:
        a_vals, b_vals = [], []
        for image, by_codec in curves.items():
            if codec_a not in by_codec or codec_b not in by_codec:
                continue
            va = _interp_at_bpp(by_codec[codec_a], target)
            vb = _interp_at_bpp(by_codec[codec_b], target)
            if va is not None and vb is not None:
                a_vals.append(va)
                b_vals.append(vb)
        if a_vals:
            result.by_target[target] = (mean(a_vals), mean(b_vals), len(a_vals))
    return result
