"""Generate the committed quality/size baselines under ``baselines/``.

The reference commits 9 per-codec baselines (baselines/*.json — per-image,
per-quality points with bpp/ssim2/size/encode_ms) and diffs every codec-iter
run against them (crates/codec-iter/src/main.rs:424-448).  This tool
produces the same artifact for this framework's codec ladder, computed on
the deterministic procedural corpus (`iter.source.synthetic_sources`) at
the quick preset, so the regression layer has committed fixtures without
committing corpus images.

Run on the CPU backend for determinism (scores drift ~1e-3 between
backends; the regression test tolerance covers it):

    JAX_PLATFORMS=cpu python tools/gen_baselines.py [--out baselines]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

QUALITIES = (75, 85, 95)  # the quick preset (main.rs:195-201)

#: key -> build_codec kwargs.  Nine entries, mirroring the reference's
#: committed set (jpeg.json + 8 avif variants) with this framework's ladder.
CONFIGS = {
    "jpeg": {"fmt": "jpeg", "subsampling": "420", "progressive": True},
    "jpeg-444": {"fmt": "jpeg", "subsampling": "444", "progressive": True},
    "webp": {"fmt": "webp"},
    "avif-baseline": {"fmt": "avif", "preset": "baseline"},
    "avif-slow": {"fmt": "avif", "preset": "slow"},
    "avif-444": {"fmt": "avif", "preset": "444"},
    "tpujpeg-420": {"fmt": "tpujpeg", "subsampling": "420"},
    "tpujpeg-trellis": {"fmt": "tpujpeg", "subsampling": "420", "trellis": True},
    "tpujpeg-xyb": {"fmt": "tpujpeg", "subsampling": "420", "xyb": True},
}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(REPO / "baselines"))
    parser.add_argument("--keys", nargs="*", default=sorted(CONFIGS))
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from codec_eval_tpu.iter import (
        build_codec,
        make_baseline,
        run_eval,
        save_baseline,
    )
    from codec_eval_tpu.iter.source import (
        SYNTHETIC_CORPUS_VERSION,
        synthetic_sources,
    )

    sources = synthetic_sources()
    out_dir = Path(args.out)
    for key in args.keys:
        codec = build_codec(**CONFIGS[key])
        result = run_eval(sources, codec, QUALITIES)
        baseline = make_baseline(
            key, codec.summary, SYNTHETIC_CORPUS_VERSION, result.points
        )
        path = save_baseline(out_dir, baseline)
        mean_s2 = sum(p.ssim2 for p in result.points) / len(result.points)
        mean_bpp = sum(p.bpp for p in result.points) / len(result.points)
        print(
            f"{path.name}: {len(result.points)} pts, "
            f"mean ssim2 {mean_s2:.2f}, mean bpp {mean_bpp:.3f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
