"""Analyze tpujpeg adaptive-quantization tuning: bpp vs quality metrics
per AQ strength.

Counterpart of the reference's scripts/analyze_aq_tuning.py, which plots
bpp vs DSSIM/SSIMULACRA2 for each AQ scale from a results CSV (matplotlib).
This version is self-contained: it *produces* the sweep (tpujpeg over the
deterministic synthetic corpus, or a corpus dir via --corpus), analyzes it,
and renders the charts with the framework's own SVG chart module (no
matplotlib dependency), plus a BD-rate table vs the aq=0 anchor.

    JAX_PLATFORMS=cpu python tools/analyze_aq_tuning.py \
        [--corpus DIR] [--out /tmp/aq_analysis] [--aq 0 0.15 0.3 0.45 0.6]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", default=None, help="image dir (default: synthetic)")
    parser.add_argument("--out", default="/tmp/aq_analysis")
    parser.add_argument(
        "--aq", nargs="*", type=float, default=[0.0, 0.15, 0.30, 0.45, 0.60]
    )
    parser.add_argument(
        "--qualities", nargs="*", type=int, default=[60, 75, 85, 95]
    )
    parser.add_argument("--limit", type=int, default=3)
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from codec_eval_tpu import ImageData, MetricConfig
    from codec_eval_tpu.codecs.tpujpeg import TpuJpegCodec
    from codec_eval_tpu.engine.helpers import evaluate_single
    from codec_eval_tpu.engine.session import EncodeRequest
    from codec_eval_tpu.iter.source import load_sources, synthetic_sources
    from codec_eval_tpu.stats import bd_rate
    from codec_eval_tpu.stats.chart import (
        ChartConfig,
        ChartPoint,
        ChartSeries,
        generate_svg,
    )

    sources = (
        load_sources(Path(args.corpus), args.limit)
        if args.corpus
        else synthetic_sources(n=args.limit)
    )
    metrics = MetricConfig.all()

    # rows[aq][q] = (mean bpp, mean dssim, mean ssim2)
    rows: dict = {}
    for aq in args.aq:
        codec = TpuJpegCodec(
            subsampling="420", adaptive=aq > 0.0, aq_strength=max(aq, 0.0)
        )
        per_q = {}
        for q in args.qualities:
            bpps, dssims, s2s = [], [], []
            for src in sources:
                image = ImageData.rgb8(src.rgb)
                data = codec.encode(image, EncodeRequest(quality=float(q)))
                decoded = codec.decode(data)
                result = evaluate_single(image, decoded, metrics)
                h, w = src.rgb.shape[:2]
                bpps.append(len(data) * 8.0 / (w * h))
                dssims.append(result.dssim)
                s2s.append(result.ssimulacra2)
            per_q[q] = (
                float(np.mean(bpps)),
                float(np.mean(dssims)),
                float(np.mean(s2s)),
            )
        rows[aq] = per_q
        print(f"aq={aq:.2f}: " + "  ".join(
            f"q{q}: {v[0]:.3f}bpp dssim={v[1]:.5f} s2={v[2]:.2f}"
            for q, v in per_q.items()
        ))

    # BD-rate vs the aq=0 anchor (must be in the sweep to anchor the table)
    anchor = min(args.aq)
    anchor_s2 = [(v[0], v[2]) for v in rows[anchor].values()]
    print(f"\nBD-rate (SSIMULACRA2) vs aq={anchor:.2f}:")
    for aq in args.aq:
        if aq == anchor:
            continue
        test = [(v[0], v[2]) for v in rows[aq].values()]
        bd = bd_rate(anchor_s2, test)
        print(f"  aq={aq:.2f}: {bd:+.2f}%" if bd is not None else
              f"  aq={aq:.2f}: n/a (<4 overlapping points)")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for metric_name, idx, lower_better in (
        ("dssim", 1, True), ("ssimulacra2", 2, False),
    ):
        palette = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#b07aa1",
                   "#76b7b2", "#edc948"]
        series = [
            ChartSeries(
                name=f"aq={aq:.2f}",
                color=palette[i % len(palette)],
                points=[
                    ChartPoint(x=v[0], y=v[idx]) for v in rows[aq].values()
                ],
            )
            for i, aq in enumerate(args.aq)
        ]
        svg = generate_svg(
            series,
            ChartConfig(
                title=f"tpujpeg AQ tuning: bpp vs {metric_name}",
                x_label="bits per pixel",
                y_label=metric_name,
                lower_is_better=lower_better,
            ),
        )
        path = out_dir / f"aq_bpp_vs_{metric_name}.svg"
        path.write_text(svg)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
