"""Measure tpujpeg's ladder position: BD-rate (SSIMULACRA2) vs PIL
libjpeg-turbo at matched subsampling, plus an aq_strength scan.

This is the measurement backing the numbers quoted in
codec_eval_tpu/codecs/tpujpeg.py's module docstring — the same
benchmark-backed-comment convention the reference uses for its AVIF ladder
(reference: crates/codec-iter/src/avif_config.rs:3-7).

Corpus: 8 synthetic 512px photos (bench.py's generator — gradients +
texture noise; no real corpus ships in this environment).  Curves: q in
{50, 60, 70, 80, 85, 90, 95}; BD-rate integrated over the overlapping
SSIMULACRA2 range per image, mean over images.

Run: ``python tools/tpujpeg_bench.py [--aq-scan]``.
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

QUALITIES = [50, 60, 70, 80, 85, 90, 95]
SIZE = 512
N_IMAGES = 8


def _clean_photo(h: int, w: int, seed: int):
    """Noise-free synthetic photo: gradients, edges, and smooth texture.
    The sensor-noise-free analog of bench._photo — AQ/trellis BD-rates on
    noisy content are inflated (the deadzone deletes exactly the noise
    SSIMULACRA2 barely scores), so this corpus is the representative one."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 120 + 60 * np.sin(x / 17.0 + rng.uniform(0, 6)) + 45 * np.cos(
        y / 11.0 + rng.uniform(0, 6)
    )
    # hard edges (architectural content)
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        ang = rng.uniform(0, np.pi)
        side = (x - cx) * np.cos(ang) + (y - cy) * np.sin(ang) > 0
        base = base + side * rng.uniform(-40, 40)
    # smooth deterministic texture
    base = base + 12 * np.sin(x * y / 900.0)
    img = np.stack([base, base * 0.9 + 10, base * 0.78 + 22], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--aq-scan", action="store_true")
    parser.add_argument("--trellis-scan", action="store_true")
    parser.add_argument("--clean", action="store_true",
                        help="use the noise-free corpus (representative "
                        "for AQ/trellis numbers)")
    parser.add_argument("--photo", action="store_true",
                        help="use the photo-statistics corpus "
                        "(iter.source.photo_sources: 1/f spectra, mixed "
                        "chroma saturation, film grain — the closest "
                        "stand-in for CID22 photographs)")
    parser.add_argument("--subsampling", default="420", choices=["420", "444"])
    parser.add_argument("--colorspace", default="ycbcr", choices=["ycbcr", "xyb"])
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from PIL import Image

    from bench import _photo
    from codec_eval_tpu.codecs.tpujpeg import TpuJpegCodec
    from codec_eval_tpu.engine.image import ImageData
    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2_batch
    from codec_eval_tpu.stats.summary import bd_rate

    if args.photo:
        from codec_eval_tpu.iter.source import PHOTO_CORPUS_VERSION, photo_sources

        refs = [s.rgb for s in photo_sources(N_IMAGES, SIZE)]
        corpus_label = PHOTO_CORPUS_VERSION
    else:
        gen = _clean_photo if args.clean else _photo
        refs = [gen(SIZE, SIZE, 40 + i) for i in range(N_IMAGES)]
        corpus_label = "synthetic-clean" if args.clean else "synthetic-noisy"
    print(f"corpus: {corpus_label} ({N_IMAGES}x {SIZE}px)")
    if args.colorspace == "xyb":
        args.subsampling = "444"
    pil_sub = 2 if args.subsampling == "420" else 0

    def pil_encode(img: np.ndarray, q: int) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(
            buf, "JPEG", quality=q, optimize=True, subsampling=pil_sub
        )
        return buf.getvalue()

    def curve(encodes: list[bytes], ref: np.ndarray, decoder=None) -> list[tuple[float, float]]:
        """[(bpp, ssim2)] for one image's quality ladder.  ``decoder``
        defaults to plain PIL; pass the codec's decode for modes whose
        channels need postprocessing (XYB)."""
        if decoder is None:
            decs = np.stack(
                [
                    np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
                    for d in encodes
                ]
            )
        else:
            decs = np.stack([decoder(d).to_rgb8() for d in encodes])
        scores = np.asarray(ssimulacra2_batch(jnp.asarray(ref), jnp.asarray(decs)))
        bpp = [len(d) * 8.0 / (SIZE * SIZE) for d in encodes]
        return list(zip(bpp, scores.tolist()))

    def mean_bd(codec: TpuJpegCodec) -> float:
        deltas = []
        for ref in refs:
            base = curve([pil_encode(ref, q) for q in QUALITIES], ref)
            test = curve(
                codec.encode_sweep(ImageData.rgb8(ref), [float(q) for q in QUALITIES]),
                ref,
                decoder=codec.decode,
            )
            d = bd_rate(base, test)
            if d is not None:
                deltas.append(d)
        return float(np.mean(deltas))

    if args.trellis_scan:
        # 2026-08-18 --clean results (s2 BD-rate): 0.05 -19.0, 0.10 -24.1,
        # 0.20 -27.8, 0.30 -27.0, 0.40 -24.6; butteraugli peaks at 0.05-0.10
        # and degrades fast above 0.20 (+4.3% at 0.40) — lambda=0.10 default.
        # Activity-modulated lambda (lambda*(1+2*act)) measured strictly
        # worse at every lambda and was removed.
        for lam in (0.05, 0.10, 0.20, 0.30):
            codec = TpuJpegCodec(
                subsampling=args.subsampling, colorspace=args.colorspace,
                trellis=True, trellis_lambda=lam,
            )
            print(f"lambda={lam:4.2f}: BD-rate vs PIL = "
                  f"{mean_bd(codec):+6.2f}%", flush=True)
        return

    if args.aq_scan:
        for s in (0.0, 0.15, 0.22, 0.30, 0.38, 0.45):
            codec = TpuJpegCodec(
                subsampling=args.subsampling, adaptive=s > 0, aq_strength=s,
                colorspace=args.colorspace,
            )
            print(f"aq_strength={s:4.2f}: BD-rate vs PIL = {mean_bd(codec):+6.2f}%")
        return

    for adaptive in (False, True):
        codec = TpuJpegCodec(
            subsampling=args.subsampling, adaptive=adaptive,
            colorspace=args.colorspace,
        )
        label = codec.id()
        print(f"{label}: BD-rate (SSIMULACRA2) vs PIL {args.subsampling} "
              f"optimized = {mean_bd(codec):+6.2f}%")


if __name__ == "__main__":
    main()
