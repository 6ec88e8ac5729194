"""Verify the DSSIM implementation's behavioral contract.

dssim-core (the crate the reference wraps, src/metrics/dssim.rs:40-70) is not
runnable in this environment, so absolute numerical parity cannot be measured
directly.  This tool checks every externally-verifiable property instead:

1. **Scale anchors** — the reference's README tabulates the dssim scale
   (README.md:258-266): < 0.001 visually identical, 0.001-0.01 excellent,
   0.01-0.05 good, 0.05-0.1 acceptable.  High-quality JPEG (q95+) must land
   below ~2e-3; mid-quality (q75) in the 'excellent'-to-'good' range;
   low quality (q30) must stay within ~an order of the 'good'-'acceptable'
   range, on photo-like content.
2. **Monotonicity** with JPEG quality per image.
3. **Expected Butteraugli relationship** — DSSIM is variance-like (quadratic
   in error amplitude) and mean-pooled; Butteraugli is amplitude-linear and
   max-pooled.  Within one image a quality sweep must rank identically
   (mean per-image spearman >= 0.8); across images the two families
   legitimately disagree, so cross-image stats are context only.  The
   log-log slope is gated from above (<= 1.2): a slope near 1 would mean a
   power-map-like rescale crept back in (round 1 'calibrated' the honest
   ~0.3-0.5 slope away, distorting relative comparisons).
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from PIL import Image

    from codec_eval_tpu.kernels.dssim import dssim_u8
    from codec_eval_tpu.utils import jxl_golden
    from tools.butteraugli_parity import make_base_images, make_distortions

    f = jax.jit(dssim_u8)
    bases = make_base_images(192)

    def jpeg(img, q):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    # 1 + 2: anchors and monotonicity on photo-like bases.
    print("== scale anchors / monotonicity (photo-like bases) ==")
    failures = []
    for bi in (0, 5, 6):
        base = bases[bi]
        vals = {q: float(f(jnp.asarray(base), jnp.asarray(jpeg(base, q))))
                for q in (30, 50, 75, 90, 96)}
        print(f"base{bi}: " + "  ".join(f"q{q}={v:.5f}" for q, v in vals.items()))
        if not all(vals[a] >= vals[b] for a, b in ((30, 50), (50, 75), (75, 90), (90, 96))):
            failures.append(f"base{bi}: not monotone: {vals}")
        if vals[96] > 2e-3:
            failures.append(f"base{bi}: q96 {vals[96]:.5f} above 'visually identical' ~2e-3")
        if not (5e-4 < vals[75] < 5e-2):
            failures.append(f"base{bi}: q75 {vals[75]:.5f} outside excellent..good range")
        if vals[30] > 0.2:
            failures.append(f"base{bi}: q30 {vals[30]:.5f} implausibly large")

    # 3: relationship with golden butteraugli on codec artifacts.
    # DSSIM mean-pools a variance-like map; Butteraugli max-pools an
    # amplitude-linear one.  WITHIN an image both must rank a quality sweep
    # the same way (strong per-image spearman); ACROSS images they
    # legitimately disagree (a metric that agreed cross-image with BA's
    # max-norm would NOT be dssim), so the cross-image statistics are
    # reported for context, not gated.
    print("\n== butteraugli relationship (codec artifacts) ==")
    from scipy.stats import spearmanr  # noqa: PLC0415

    rng = np.random.default_rng(11)
    ds, ba, per_img = [], [], []
    for i, base in enumerate(bases):
        if i == 3:
            continue  # saturated patches: BA max-norm pins, carries no slope info
        ds_i, ba_i = [], []
        for tag, dist in make_distortions(base, rng):
            if not (tag.startswith("jpeg") or tag.startswith("webp")):
                continue
            g = jxl_golden.butteraugli_golden(base, dist)
            d = float(f(jnp.asarray(base), jnp.asarray(dist)))
            if np.isfinite(g) and g > 0 and d > 0:
                ds.append(d)
                ba.append(g)
                ds_i.append(d)
                ba_i.append(g)
        per_img.append(spearmanr(ds_i, ba_i).statistic)
    ds, ba = np.array(ds), np.array(ba)
    slope = np.polyfit(np.log(ds), np.log(ba), 1)[0]
    rho = spearmanr(ds, ba).statistic
    print(f"{len(ds)} pairs, cross-image (context only): "
          f"d(logBA)/d(logDSSIM) = {slope:.3f}, spearman = {rho:.3f}")
    print("per-image spearman vs BA: "
          + " ".join(f"{x:.3f}" for x in per_img))
    mean_rho = float(np.mean(per_img))
    print(f"mean per-image spearman = {mean_rho:.3f}")
    if mean_rho < 0.8:
        failures.append(f"mean per-image spearman {mean_rho:.3f} < 0.8")
    if slope > 1.2:
        failures.append(
            f"log slope {slope:.3f} > 1.2: dssim range compressed vs BA — "
            "a power-map-like distortion has crept back in"
        )

    if failures:
        print("\nFAILURES:")
        for msg in failures:
            print(f"  - {msg}")
        sys.exit(1)
    print("\nall DSSIM contract checks passed")


if __name__ == "__main__":
    main()
