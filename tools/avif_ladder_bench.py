"""Measure BD-rate / encode-time tradeoffs of the AVIF preset ladder.

The analog of the benchmark-backed comments in the reference's
crates/codec-iter/src/avif_config.rs:3-7 (qm ~ -10% BD-rate at ~1x time for
rav1e): encodes a small synthetic corpus through every ``AvifCodec.presets()``
entry across a quality sweep, scores SSIMULACRA2 on device, and prints
BD-rate vs the `baseline` preset plus the encode-time ratio.  Paste the
output table into the AvifCodec docstring when the ladder changes.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

QUALITIES = [35, 45, 55, 65, 75, 85]
SIZE = 512
N_IMAGES = 6


def main() -> None:
    import argparse

    import jax
    import jax.numpy as jnp

    parser = argparse.ArgumentParser()
    parser.add_argument("--photo", action="store_true",
                        help="use the photo-statistics corpus "
                        "(iter.source.photo_sources) instead of the "
                        "trig-pattern bases")
    args = parser.parse_args()

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from codec_eval_tpu.codecs.pil_codecs import AvifCodec
    from codec_eval_tpu.engine import EncodeRequest, ImageData
    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2_batch
    from codec_eval_tpu.stats.summary import bd_rate
    from tools.butteraugli_parity import make_base_images

    if args.photo:
        from codec_eval_tpu.iter.source import PHOTO_CORPUS_VERSION, photo_sources

        bases = [s.rgb for s in photo_sources(N_IMAGES, SIZE)]
        print(f"corpus: {PHOTO_CORPUS_VERSION} ({N_IMAGES}x {SIZE}px)")
    else:
        bases = [b for b in make_base_images(SIZE)[:N_IMAGES]]
        print(f"corpus: synthetic-trig ({N_IMAGES}x {SIZE}px)")
    score = jax.jit(ssimulacra2_batch)

    results = {}
    for codec in AvifCodec.presets():
        if not codec.is_available():
            print("AVIF unavailable")
            return
        t_enc = 0.0
        pts = []  # (bpp, ssim2) corpus means per quality
        per_q = {q: [] for q in QUALITIES}
        for base in bases:
            img = ImageData.rgb8(base)
            cands, bpps = [], []
            for q in QUALITIES:
                t0 = time.perf_counter()
                data = codec.encode(img, EncodeRequest(quality=float(q)))
                t_enc += time.perf_counter() - t0
                cands.append(codec.decode(data).to_rgb8())
                bpps.append(len(data) * 8.0 / (SIZE * SIZE))
            scores = np.asarray(score(jnp.asarray(base), jnp.asarray(np.stack(cands))))
            for q, b, s in zip(QUALITIES, bpps, scores):
                per_q[q].append((b, float(s)))
        for q in QUALITIES:
            arr = np.array(per_q[q])
            pts.append((q, arr[:, 0].mean(), arr[:, 1].mean()))
        results[codec.label] = {"points": pts, "encode_s": t_enc}

    base_pts = [(b, s) for _, b, s in results["baseline"]["points"]]
    base_t = results["baseline"]["encode_s"]
    print(f"{'preset':12s} {'BD-rate(s2)':>12s} {'time x':>7s}")
    for label, r in results.items():
        test_pts = [(b, s) for _, b, s in r["points"]]
        bd = bd_rate(base_pts, test_pts)
        bd = float("nan") if bd is None else bd
        print(f"{label:12s} {bd:>11.2f}% {r['encode_s'] / base_t:>7.2f}")


if __name__ == "__main__":
    main()
