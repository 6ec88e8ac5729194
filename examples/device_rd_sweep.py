"""Device-resident R-D sweep: evaluate a tpujpeg quality ladder without
candidate pixels ever leaving the device.

The conventional loop (examples/basic_eval.py) round-trips every candidate
through host RAM: encode -> decode -> stage to device -> score.  With the
in-house tpujpeg encoder the transform half already lives on device, so the
whole ladder — encode, decode (dequantize + inverse DCT + fancy chroma
upsample), and all-metric scoring — runs as two device dispatches per
image; the host entropy-codes the device-produced coefficients only to
report exact .jpg byte sizes.

Run: python examples/device_rd_sweep.py
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from codec_eval_tpu.engine import evaluate_tpujpeg_sweep  # noqa: E402
from codec_eval_tpu.parallel import sweep_corpus_ladders  # noqa: E402


def photo(seed, h=256, w=256):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 70 * np.sin(x / 17.0 + seed) + 40 * np.cos(y / 11.0)
    img = np.stack([base, base * 0.9 + 10, base * 0.8 + 20], -1)
    return np.clip(img + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def main():
    qualities = [50.0, 65.0, 80.0, 90.0, 95.0]

    # One image: per-quality rows with exact sizes.
    print("single image ladder:")
    for p in evaluate_tpujpeg_sweep(photo(0), qualities):
        print(
            f"  q{p.quality:5.1f}  {p.bits_per_pixel:6.3f} bpp  "
            f"s2={p.metrics['ssimulacra2']:6.2f}  "
            f"ba={p.metrics['butteraugli']:6.3f}  "
            f"dssim={p.metrics['dssim']:8.5f}"
        )

    # A small corpus, sharded over the device mesh (on one chip this is a
    # plain loop; on a pod slice each device sweeps its shard of images).
    images = [photo(i) for i in range(4)]
    res = sweep_corpus_ladders(images, qualities)
    print("\ncorpus-mean R-D curve (ssimulacra2):")
    for bpp, s2 in res.mean_curve("ssimulacra2"):
        print(f"  {bpp:6.3f} bpp -> {s2:6.2f}")


if __name__ == "__main__":
    main()
