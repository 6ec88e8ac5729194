"""Measure score sensitivity of the approximate SSIMULACRA2 weight entries.

For each entry in ``ssimulacra2_weights.APPROX_ENTRIES``, perturbs the weight
by +10% and reports the score change on JPEG-q75/q90 pairs — the empirical
bound on how much parity error each approximated table entry can contribute
(backs the sensitivity classes documented next to APPROX_ENTRIES).
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

    from codec_eval_tpu.kernels import ssimulacra2_weights as W
    from codec_eval_tpu.kernels.ssimulacra2 import (
        features_against_reference,
        precompute_reference,
    )
    from tools.butteraugli_parity import make_base_images

    def jpeg(img, q):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    def score_with(feats, weights):
        s = float(np.sum(weights * np.abs(feats)) * W.SCALE_FACTOR)
        v = (W.CUBIC_A * s * s + W.CUBIC_B * s + W.CUBIC_C) * s
        return 100.0 - 10.0 * v**W.POWER if v > 0 else 100.0

    featsets = []
    for base in make_base_images(256)[:4]:
        ref = precompute_reference(jnp.asarray(base))
        for q in (75, 90):
            feats = np.asarray(
                features_against_reference(ref, jnp.asarray(jpeg(base, q)))
            )
            featsets.append(feats)

    base_w = W.WEIGHTS_V21.copy()
    print(f"{len(featsets)} feature vectors; +10% perturbation per entry:")
    for idx, label, klass in W.APPROX_ENTRIES:
        pert = base_w.copy()
        pert[idx] *= 1.10
        deltas = [
            abs(score_with(f, pert) - score_with(f, base_w)) for f in featsets
        ]
        print(
            f"  w[{idx:3d}] {label:24s} max |dscore| = {max(deltas):8.5f}  "
            f"(documented: {klass.split(':')[0]})"
        )


if __name__ == "__main__":
    main()
