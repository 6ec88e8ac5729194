"""Empirically resolve dssim-core's two structural unknowns (VERDICT r2 #4).

dssim-core's published recipe leaves two details undetermined in this
environment (no source / binary to diff against):

  (a) how many times its separable 3-tap window is applied per moment map
      (1 pass = sigma~0.79; 3-4 passes approximate classic SSIM's sigma-1.5
      11-tap window);
  (b) how the 2x2 pyramid downsample rounds odd dimensions (edge-clamped
      ceil vs floor-truncate).

This tool scores a diverse synthetic corpus (odd-size, so rounding matters)
under all 4 x 2 combinations and evaluates each against the published
behavior anchors the reference gives us:

  A1  the dssim decade table (reference README.md:258-266): q95+ JPEG
      < ~1e-3 "visually identical", q85 in the "excellent" decade
      [1e-3, 1e-2], mid-quality in "good" [1e-2, 5e-2];
  A2  agreement with the reference's PerceptionLevel thresholds
      (src/metrics/mod.rs:17-27): the DSSIM-assigned level should agree
      with the SSIMULACRA2-assigned level (the thresholds were designed as
      one consistent ladder; SSIM2 is our strongest independently-verified
      metric) — scored as mean |level index delta|;
  A3  rank behavior: Spearman correlation with Butteraugli (oracle-
      verified) and with -SSIMULACRA2 across all pairs (TID2013 gives
      dssim |rho| 0.84-0.95; a variant that degrades rank agreement with
      two verified metrics is suspect).

Output: the decision matrix committed to docs/dssim_decision_matrix.md.

Usage: python tools/dssim_variant_matrix.py [--size 167]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

LEVELS = ["Imperceptible", "Marginal", "Subtle", "Noticeable", "Degraded"]


def _level_idx(level) -> int:
    return LEVELS.index(level.value)


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=167,
                        help="odd size so downsample rounding matters")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from PIL import Image

    from butteraugli_parity import make_base_images

    from codec_eval_tpu.kernels.butteraugli import butteraugli
    from codec_eval_tpu.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu.kernels.dssim import dssim
    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2
    from codec_eval_tpu.metrics import PerceptionLevel

    def jpeg(img, q):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    qualities = [25, 35, 45, 55, 65, 75, 85, 92, 95, 98]
    rng = np.random.default_rng(11)
    bases = make_base_images(args.size)

    # Build (name, ref, dist) pairs: JPEG sweep + noise/blur for rank spread.
    pairs = []
    for bi, base in enumerate(bases):
        for q in qualities:
            pairs.append((f"b{bi}/jpeg{q}", q, base, jpeg(base, q)))
        noisy = np.clip(
            base.astype(np.float64) + rng.normal(0, 3.0, base.shape), 0, 255
        ).astype(np.uint8)
        pairs.append((f"b{bi}/noise3", None, base, noisy))

    # Verified metrics, once per pair.
    s2_fn = jax.jit(ssimulacra2)
    ba_fn = jax.jit(butteraugli)
    s2 = np.array([float(s2_fn(jnp.asarray(r), jnp.asarray(d))) for _, _, r, d in pairs])
    ba = np.array([float(ba_fn(jnp.asarray(r), jnp.asarray(d))) for _, _, r, d in pairs])
    print(f"{len(pairs)} pairs scored with SSIM2 + Butteraugli")

    # Stage linear-light inputs once.
    linear = [
        (srgb_u8_to_linear(jnp.asarray(r)), srgb_u8_to_linear(jnp.asarray(d)))
        for _, _, r, d in pairs
    ]

    print(
        f"\n{'variant':16s} {'q95':>9s} {'q85':>9s} {'q75':>9s} {'q45':>9s} "
        f"{'q25':>9s} {'A1 hits':>8s} {'A2 lvlΔ':>8s} {'ρ(BA)':>7s} {'ρ(-S2)':>7s}"
    )
    rows = []
    for passes in (1, 2, 3, 4):
        for mode in ("ceil", "floor"):
            fn = jax.jit(
                lambda a, b, p=passes, m=mode: dssim(a, b, blur_passes=p, downscale=m)
            )
            ds = np.array([float(fn(l1, l2)) for l1, l2 in linear])

            # A1: decade-band placement of the mean JPEG-q scores.
            qmeans = {}
            for q in qualities:
                idx = [i for i, (_, pq, _, _) in enumerate(pairs) if pq == q]
                qmeans[q] = float(np.mean(ds[idx]))
            anchors = [
                qmeans[95] <= 1.5e-3,          # visually identical decade
                1e-3 <= qmeans[85] <= 1e-2,     # excellent decade
                5e-3 <= qmeans[75] <= 3e-2,     # excellent/good boundary
                1e-2 <= qmeans[45] <= 8e-2,     # good/acceptable
                qmeans[25] >= 2e-2,             # approaching noticeable
            ]
            a1 = sum(anchors)

            # A2: PerceptionLevel agreement with SSIM2 (mean |level delta|).
            lvl_d = np.mean(
                [
                    abs(
                        _level_idx(PerceptionLevel.from_dssim(ds[i]))
                        - _level_idx(PerceptionLevel.from_ssimulacra2(s2[i]))
                    )
                    for i in range(len(pairs))
                ]
            )

            # A3: rank agreement with verified metrics.
            rho_ba = _spearman(ds, ba)
            rho_s2 = _spearman(ds, -s2)

            rows.append((passes, mode, qmeans, a1, lvl_d, rho_ba, rho_s2))
            print(
                f"passes={passes} {mode:5s} {qmeans[95]:9.5f} {qmeans[85]:9.5f} "
                f"{qmeans[75]:9.5f} {qmeans[45]:9.5f} {qmeans[25]:9.5f} "
                f"{a1:5d}/5 {lvl_d:8.3f} {rho_ba:7.3f} {rho_s2:7.3f}"
            )

    # Rank variants: A1 first, then rank agreement with the two verified
    # metrics (the discriminating anchor — level-delta differences are tiny
    # because the PerceptionLevel ladder is strict for ALL variants, which
    # the reference itself notes: its DSSIM thresholds are a much stricter
    # ladder than the decade table), then level-delta.
    best = max(
        rows, key=lambda r: (r[3], (r[5] + r[6]) / 2, -r[4])
    )
    print(
        f"\nwinner: blur_passes={best[0]} downscale={best[1]} "
        f"(A1 {best[3]}/5, level-delta {best[4]:.3f}, "
        f"rho(BA) {best[5]:.3f}, rho(-S2) {best[6]:.3f})"
    )


if __name__ == "__main__":
    main()
