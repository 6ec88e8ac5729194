"""rd-calibrate: R-D knee calibration pipeline.

Behavioral port of reference: crates/codec-compare/src/rd_calibrate.rs:53-379
— sweep one codec over a fine quality grid across a corpus, aggregate the
per-quality corpus-mean curve, detect the SSIMULACRA2/Butteraugli knees,
plot the dark-theme R-D SVG, and print ready-to-paste calibration code.

Accelerator redesign of the hot path: the reference fans the (image x quality) grid
over rayon threads with per-pair native metric calls; here each image's full
quality sweep is scored in one fused device batch (SSIMULACRA2 + Butteraugli
in the same program), and per-quality corpus means reduce on host from the
per-image score vectors.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..corpus import Corpus
from ..errors import CodecEvalError
from ..iter.codecs import build_codec
from ..stats import CorpusAggregate, WEB_FRAME
from ..stats.rd_plot import plot_rd_svg


def parse_range(spec: str) -> List[int]:
    """"10:2:98" -> [10, 12, ..., 98].  reference: rd_calibrate.rs:53-64."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise CodecEvalError(f"range spec must be start:step:end, got '{spec}'")
    start, step, end = (int(p) for p in parts)
    if step <= 0 or end < start:
        raise CodecEvalError(f"invalid range '{spec}'")
    return list(range(start, end + 1, step))


def sweep_corpus(
    corpus: Corpus,
    codec,
    qualities: List[int],
    limit: int = 0,
    progress=print,
) -> Dict[int, List[Tuple[float, float, float]]]:
    """Per-quality lists of (bpp, s2, ba) across images."""
    import jax
    import jax.numpy as jnp

    from ..kernels.butteraugli import (
        butteraugli_against_reference,
        precompute_butteraugli_reference,
    )
    from ..kernels.ssimulacra2 import (
        features_against_reference,
        precompute_reference,
        score_from_features,
    )

    @jax.jit
    def score_sweep(ref_u8, batch_u8):
        pre = precompute_reference(ref_u8)
        s2 = jax.vmap(
            lambda d: score_from_features(features_against_reference(pre, d))
        )(batch_u8)
        bref = precompute_butteraugli_reference(ref_u8)
        ba = jax.vmap(lambda d: butteraugli_against_reference(bref, d))(batch_u8)
        return s2, ba

    images = corpus.images[:limit] if limit else corpus.images
    by_quality: Dict[int, List[Tuple[float, float, float]]] = {
        q: [] for q in qualities
    }
    for i, corpus_image in enumerate(images):
        path = corpus_image.full_path(corpus.root_path)
        try:
            from PIL import Image

            rgb = np.asarray(Image.open(path).convert("RGB"))
        except Exception as e:  # noqa: BLE001 - skip-and-continue policy
            progress(f"  SKIP {corpus_image.relative_path}: {e}")
            continue
        h, w = rgb.shape[:2]

        encoded = []
        for q in qualities:
            data = codec.encode(rgb, q)
            decoded = codec.decode(data)
            encoded.append((len(data), decoded))

        batch = np.stack([d for _, d in encoded])
        s2s, bas = score_sweep(jnp.asarray(rgb), jnp.asarray(batch))
        s2s, bas = np.asarray(s2s), np.asarray(bas)
        for q, (size, _), s2, ba in zip(qualities, encoded, s2s, bas):
            if np.isfinite(s2) and np.isfinite(ba):
                # Drop non-finite scores (reference: rd_calibrate.rs:144-148).
                by_quality[q].append((size * 8.0 / (w * h), float(s2), float(ba)))
        progress(f"  [{i + 1}/{len(images)}] {corpus_image.relative_path}")
    return by_quality


def aggregate_curve(
    by_quality: Dict[int, List[Tuple[float, float, float]]]
) -> List[Tuple[float, float, float]]:
    """Per-quality corpus means sorted by bpp.
    reference: rd_calibrate.rs:240-260."""
    curve = []
    for q in sorted(by_quality):
        samples = by_quality[q]
        if not samples:
            continue
        n = len(samples)
        curve.append(
            (
                sum(s[0] for s in samples) / n,
                sum(s[1] for s in samples) / n,
                sum(s[2] for s in samples) / n,
            )
        )
    curve.sort(key=lambda p: p[0])
    return curve


def emit_calibration_code(cal, corpus_name: str, codec_id: str) -> str:
    """Ready-to-paste defaults code.  reference: rd_calibrate.rs:322-379."""
    s2, ba = cal.ssimulacra2, cal.butteraugli
    return f'''\
# Generated calibration for {codec_id} on {corpus_name}
RDCalibration(
    frame=WEB_FRAME,
    ssimulacra2=RDKnee(
        bpp={s2.bpp:.4f}, quality={s2.quality:.2f},
        fixed_angle=WEB_FRAME.s2_angle({s2.bpp:.4f}, {s2.quality:.2f}),
        norm=NormalizationContext(
            bpp_range=AxisRange({s2.norm.bpp_range.min:.4f}, {s2.norm.bpp_range.max:.4f}),
            quality_range=AxisRange({s2.norm.quality_range.min:.2f}, {s2.norm.quality_range.max:.2f}),
            direction=QualityDirection.HIGHER_IS_BETTER,
        ),
    ),
    butteraugli=RDKnee(
        bpp={ba.bpp:.4f}, quality={ba.quality:.3f},
        fixed_angle=WEB_FRAME.ba_angle({ba.bpp:.4f}, {ba.quality:.3f}),
        norm=NormalizationContext(
            bpp_range=AxisRange({ba.norm.bpp_range.min:.4f}, {ba.norm.bpp_range.max:.4f}),
            quality_range=AxisRange({ba.norm.quality_range.min:.3f}, {ba.norm.quality_range.max:.3f}),
            direction=QualityDirection.LOWER_IS_BETTER,
        ),
    ),
    corpus="{corpus_name}",
    codec="{codec_id}",
    image_count={cal.image_count},
)'''


def sweep_corpus_device(
    corpus: Corpus,
    qualities: List[int],
    subsampling: str = "420",
    limit: int = 0,
    progress=print,
    trellis: bool = False,
    size_mode: str = "exact",
) -> Dict[int, List[Tuple[float, float, float]]]:
    """Device-resident calibration sweep: the entire encode/decode/score
    inner loop of the reference's rd_calibrate hot path
    (rd_calibrate.rs:184-216) runs on the mesh via the tpujpeg ladder
    runner (parallel/ladder_runner.py); images are grouped by shape (one
    SPMD program per shape)."""
    from collections import defaultdict

    from ..parallel.ladder_runner import sweep_corpus_ladders

    images = corpus.images[:limit] if limit else corpus.images
    by_shape: Dict[Tuple[int, int], list] = defaultdict(list)
    for corpus_image in images:
        path = corpus_image.full_path(corpus.root_path)
        try:
            from PIL import Image

            rgb = np.asarray(Image.open(path).convert("RGB"))
        except Exception as e:  # noqa: BLE001 - skip-and-continue policy
            progress(f"  SKIP {corpus_image.relative_path}: {e}")
            continue
        by_shape[rgb.shape[:2]].append(rgb)

    by_quality: Dict[int, List[Tuple[float, float, float]]] = {
        q: [] for q in qualities
    }
    done = 0
    total = sum(len(v) for v in by_shape.values())
    for (h, w), rgbs in by_shape.items():
        res = sweep_corpus_ladders(
            rgbs,
            [float(q) for q in qualities],
            subsampling=subsampling,
            metrics=("ssimulacra2", "butteraugli"),
            aq_strength=0.0 if trellis else 0.30,
            trellis_lambda=0.10 if trellis else 0.0,
            with_sizes="device" if size_mode == "device" else True,
        )
        s2 = res.scores["ssimulacra2"]
        ba = res.scores["butteraugli"]
        for ii in range(len(rgbs)):
            for qi, q in enumerate(qualities):
                if np.isfinite(s2[ii, qi]) and np.isfinite(ba[ii, qi]):
                    by_quality[q].append(
                        (
                            float(res.bits_per_pixel[ii, qi]),
                            float(s2[ii, qi]),
                            float(ba[ii, qi]),
                        )
                    )
        done += len(rgbs)
        progress(f"  [{done}/{total}] {h}x{w} group ({len(rgbs)} images)")
    return by_quality


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rd-calibrate")
    parser.add_argument("corpus", type=Path)
    parser.add_argument("--range", default="10:2:98", help="start:step:end")
    parser.add_argument("--format", default="jpeg")
    parser.add_argument("--subsampling", default="420")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--output", type=Path, default=Path("./rd_calibration"))
    parser.add_argument(
        "--device-sweep",
        action="store_true",
        help="tpujpeg only: run the whole calibration sweep (encode, "
        "decode, score) on the device mesh",
    )
    parser.add_argument(
        "--trellis",
        action="store_true",
        help="tpujpeg only: trellis quantization (device DP under "
        "--device-sweep)",
    )
    parser.add_argument(
        "--size-mode",
        choices=("exact", "device"),
        default="exact",
        help="--device-sweep byte sizes: 'exact' entropy-codes on host; "
        "'device' computes them from on-device rate statistics "
        "(entropy-exact, stuffing estimated ~0.15%%)",
    )
    args = parser.parse_args(argv)

    try:
        qualities = parse_range(args.range)
        if args.device_sweep and args.format != "tpujpeg":
            print("error: --device-sweep requires --format tpujpeg",
                  file=sys.stderr)
            return 2
        codec = (
            None
            if args.device_sweep
            else build_codec(
                args.format, subsampling=args.subsampling,
                trellis=args.trellis,
            )
        )
        corpus = Corpus.discover(args.corpus)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    summary = (
        f"tpujpeg-{args.subsampling}-"
        f"{'trellis' if args.trellis else 'aq'}-device"
        if args.device_sweep
        else codec.summary
    )
    print(f"rd-calibrate: {summary} x {len(qualities)} qualities "
          f"on {len(corpus)} images")
    t0 = time.perf_counter()
    if args.device_sweep:
        by_quality = sweep_corpus_device(
            corpus, qualities, subsampling=args.subsampling,
            limit=args.limit, trellis=args.trellis,
            size_mode=args.size_mode,
        )
    else:
        by_quality = sweep_corpus(corpus, codec, qualities, limit=args.limit)
    curve = aggregate_curve(by_quality)
    if len(curve) < 3:
        print("error: not enough data for knee detection", file=sys.stderr)
        return 1

    image_count = max(len(v) for v in by_quality.values())
    agg = CorpusAggregate(corpus.name, summary, curve, image_count)
    cal = agg.calibrate(WEB_FRAME)
    if cal is None:
        print("error: knee detection failed", file=sys.stderr)
        return 1

    dt = time.perf_counter() - t0
    print(f"\nsweep complete in {dt:.1f}s")
    print(f"s2 knee: {cal.ssimulacra2.bpp:.4f} bpp @ {cal.ssimulacra2.quality:.2f} "
          f"({cal.ssimulacra2.fixed_angle:.1f} deg)")
    print(f"ba knee: {cal.butteraugli.bpp:.4f} bpp @ {cal.butteraugli.quality:.3f} "
          f"({cal.butteraugli.fixed_angle:.1f} deg)")

    args.output.mkdir(parents=True, exist_ok=True)
    svg = plot_rd_svg(curve, WEB_FRAME, cal,
                      title=f"R-D: {summary} on {corpus.name}")
    (args.output / "rd_curve.svg").write_text(svg)
    code = emit_calibration_code(cal, corpus.name, summary)
    (args.output / "calibration.py").write_text(code + "\n")
    # Machine-readable calibration for tooling (tools/clic_calibration_check
    # .py and CI): knees + provenance.
    import json

    (args.output / "calibration.json").write_text(
        json.dumps(
            {
                "corpus": corpus.name,
                "codec": summary,
                "image_count": image_count,
                "ssimulacra2": {
                    "bpp": cal.ssimulacra2.bpp,
                    "score": cal.ssimulacra2.quality,
                    "angle": cal.ssimulacra2.fixed_angle,
                },
                "butteraugli": {
                    "bpp": cal.butteraugli.bpp,
                    "score": cal.butteraugli.quality,
                    "angle": cal.butteraugli.fixed_angle,
                },
            },
            indent=2,
        )
        + "\n"
    )
    print(f"\nwrote {args.output}/rd_curve.svg, calibration.py, calibration.json")
    print("\n" + code)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
