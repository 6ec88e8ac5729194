"""Reproduce the CLIC-class (2048px) knee calibration end to end (VERDICT r2 #3).

The reference calibrates R-D knees on ~2048px CLIC2025 images
(src/stats/rd_knee.rs:1049-1084: s2 knee 0.4623 bpp @ 58.95, ba knee
0.3948 bpp @ 5.192).  No real CLIC corpus exists in this environment, so
this tool drives the SAME pipeline — `rd-calibrate --device-sweep` (the
device-resident tpujpeg ladder sharded over the mesh) — over a synthetic
photo-statistics 2048px corpus (iter.source.photo_sources) and verifies:

  1. the 2048px device path runs end to end (fits device memory);
  2. both knees are detected with finite bpp/score/angle;
  3. the knee is sane (bpp in [0.1, 3.0], s2 in [40, 95]).  The synthetic
     corpus knees sit HIGHER than CLIC's (measured 2026-08-19: s2 knee
     1.78 bpp @ 87.6 vs CLIC's 0.46 bpp @ 59): photo_sources' film grain
     is incompressible for JPEG, inflating bpp at every quality — which
     is exactly why every published number carries its corpus label.

Usage: python tools/clic_calibration_check.py [--size 2048] [--n 4]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=2048)
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--range", default="10:8:98")
    parser.add_argument("--keep", action="store_true")
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from PIL import Image

    from codec_eval_tpu.cli.rd_calibrate import main as rd_main
    from codec_eval_tpu.iter.source import PHOTO_CORPUS_VERSION, photo_sources

    with tempfile.TemporaryDirectory() as td:
        corpus = Path(td) / "corpus"
        corpus.mkdir()
        for s in photo_sources(args.n, args.size):
            Image.fromarray(s.rgb).save(corpus / f"{s.name}.png")
        out = Path(td) / "calib"
        rc = rd_main(
            [
                str(corpus),
                "--device-sweep",
                "--format",
                "tpujpeg",
                "--range",
                args.range,
                "--size-mode",
                "device",
                "--output",
                str(out),
            ]
        )
        assert rc == 0, rc

        import json

        calib = json.loads((out / "calibration.json").read_text())
        s2 = calib["ssimulacra2"]
        ba = calib["butteraugli"]
        print(
            f"\ncorpus: {PHOTO_CORPUS_VERSION} x{args.n} @ {args.size}px "
            f"(synthetic; reference CLIC2025 numbers are photographs)"
        )
        print(f"s2 knee: {s2['bpp']:.4f} bpp @ {s2['score']:.2f} ({s2['angle']:.1f} deg)")
        print(f"ba knee: {ba['bpp']:.4f} bpp @ {ba['score']:.2f} ({ba['angle']:.1f} deg)")
        assert 0.1 <= s2["bpp"] <= 3.0, s2
        assert 40.0 <= s2["score"] <= 95.0, s2
        assert 0.05 <= ba["bpp"] <= 3.0, ba
        print("CLIC-class calibration check OK")


if __name__ == "__main__":
    main()
