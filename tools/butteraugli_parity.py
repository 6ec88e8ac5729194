"""Butteraugli parity verification against the canonical libjxl oracle.

The round-1 build *calibrated* a structural surrogate; round 2 replaced it
with a faithful port of the public algorithm (every constant recovered from
the system library — see docs/butteraugli_algorithm_notes.md), so this tool
now only *verifies*: it scores a diverse synthetic distortion corpus with
both the JAX kernel and the libjxl golden oracle and reports the relative
error distribution (median / p90 / max) plus distmap agreement.

Usage: python tools/butteraugli_parity.py [--size 192]
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def make_base_images(size: int):
    """Diverse synthetic bases: smooth, textured, edged, colorful, dark."""
    h = w = size
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(42)
    images = []

    # 1. smooth gradient + soft blobs (sky-like)
    base = 140 + 60 * (x / w) + 30 * np.sin(y / 37.0)
    img = np.stack([base * 0.8 + 40, base * 0.9 + 20, base], -1)
    images.append(img)

    # 2. fine texture (grass/fabric)
    tex = 110 + 35 * np.sin(x / 2.3) * np.cos(y / 3.1) + rng.normal(0, 18, (h, w))
    img = np.stack([tex * 0.7 + 20, tex, tex * 0.5 + 15], -1)
    images.append(img)

    # 3. strong edges (architecture/text-like)
    edges = 60 + 160 * ((np.floor(x / 17) + np.floor(y / 23)) % 2)
    edges = edges + 20 * np.sin(x / 5.0)
    img = np.stack([edges, edges * 0.95, edges * 0.9], -1)
    images.append(img)

    # 4. saturated color patches
    px = (np.floor(x / 31) * 53 + np.floor(y / 29) * 97) % 255
    img = np.stack([px, (px * 3) % 255, (px * 7) % 255], -1)
    images.append(img)

    # 5. dark low-contrast scene
    dark = 28 + 20 * np.sin(x / 19.0) + 12 * np.cos(y / 11.0) + rng.normal(0, 4, (h, w))
    img = np.stack([dark, dark * 1.1 + 4, dark * 1.3 + 8], -1)
    images.append(img)

    # 6. photo-like mix
    mix = (
        120
        + 68 * np.sin(x / 13.0)
        + 52 * np.cos(y / 9.0)
        + 24 * np.sin((x + y) / 31.0)
        + rng.normal(0, 7, (h, w))
    )
    img = np.stack([mix, mix * 0.88 + 12, mix * 0.74 + 26], -1)
    images.append(img)

    # 7. smooth portrait-like blobs (skin tones, slow gradients)
    cx, cy = w * 0.55, h * 0.45
    rr = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    skin = 190 - 0.35 * rr + 6 * np.sin(rr / 9.0)
    img = np.stack([skin, skin * 0.8 + 8, skin * 0.66 + 10], -1)
    images.append(img)

    # 8. text-like strokes on light background
    text = np.full((h, w), 235.0)
    stroke = ((np.sin(x / 2.1) > 0.4) & (np.sin(y / 5.3) > -0.2)) & (
        ((x // 24) + (y // 16)) % 3 != 0
    )
    text[stroke] = 25.0
    img = np.stack([text, text, text], -1)
    images.append(img)

    return [np.clip(i, 0, 255).astype(np.uint8) for i in images]


def make_distortions(img: np.ndarray, rng: np.random.Generator):
    """JPEG / WebP sweeps, noise, blur — the artifact families that matter."""
    from PIL import Image, ImageFilter

    out = []

    def jpeg(q):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    def webp(q):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", quality=q)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    for q in (25, 40, 55, 70, 85, 95):
        out.append((f"jpeg{q}", jpeg(q)))
    for q in (30, 60, 90):
        out.append((f"webp{q}", webp(q)))
    for sigma in (1.5, 4.0, 9.0):
        noisy = np.clip(
            img.astype(np.float64) + rng.normal(0, sigma, img.shape), 0, 255
        ).astype(np.uint8)
        out.append((f"noise{sigma}", noisy))
    for radius in (0.6, 1.5):
        blurred = np.array(
            Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))
        )
        out.append((f"blur{radius}", blurred))
    # Banding: coarse quantization of smooth regions (posterization).
    for levels in (16, 32):
        q = 255 // (levels - 1)
        banded = (np.round(img.astype(np.int32) / q) * q).clip(0, 255)
        out.append((f"band{levels}", banded.astype(np.uint8)))
    # Ringing-like oversharpening.
    sharp = np.array(
        Image.fromarray(img).filter(
            ImageFilter.UnsharpMask(radius=2, percent=220, threshold=0)
        )
    )
    out.append(("sharpen", sharp))
    # Resampling softness: downscale-upscale round trip.
    h2, w2 = img.shape[0], img.shape[1]
    small = Image.fromarray(img).resize((w2 // 2, h2 // 2), Image.BILINEAR)
    out.append(("rescale", np.array(small.resize((w2, h2), Image.BILINEAR))))
    # Chroma-only error (color cast), luma preserved.
    cast = img.astype(np.int16).copy()
    cast[..., 0] += 6
    cast[..., 2] -= 6
    out.append(("cast", np.clip(cast, 0, 255).astype(np.uint8)))
    return out



def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=192)
    parser.add_argument("--distmaps", action="store_true",
                        help="also compare full distance maps")
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from codec_eval_tpu.kernels.butteraugli import butteraugli, butteraugli_distmap
    from codec_eval_tpu.utils import jxl_golden

    if not jxl_golden.is_available():
        print("libjxl oracle unavailable; nothing to verify")
        return

    rng = np.random.default_rng(7)
    rels = []
    map_rels = []
    for bi, base in enumerate(make_base_images(args.size)):
        for name, dist in make_distortions(base, rng):
            gold = jxl_golden.butteraugli_golden(base, dist)
            ours = float(butteraugli(base, dist))
            rel = abs(ours - gold) / max(gold, 1e-9)
            rels.append(rel)
            line = f"base{bi} {name:10s} gold={gold:8.4f} ours={ours:8.4f} rel={100 * rel:6.2f}%"
            if args.distmaps:
                gm = jxl_golden.butteraugli_distmap(base, dist)
                om = np.asarray(butteraugli_distmap(base, dist))
                mr = float(np.mean(np.abs(om - gm) / (np.abs(gm) + 0.05)))
                map_rels.append(mr)
                line += f"  map_rel={100 * mr:5.2f}%"
            print(line)
    rels = np.array(rels)
    print(
        f"\nscore rel err: median {100 * np.median(rels):.2f}%  "
        f"p90 {100 * np.quantile(rels, 0.9):.2f}%  max {100 * rels.max():.2f}%"
    )
    if map_rels:
        print(f"distmap mean rel err: median {100 * np.median(map_rels):.2f}%")


if __name__ == "__main__":
    main()
