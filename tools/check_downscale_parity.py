"""Device parity check of the pyramid steps against float64 numpy.

``downscale_by_2`` (SSIMULACRA2/DSSIM pyramids), ``butteraugli._subsample2x``
and ``butteraugli._add_supersampled2x`` are checked at production widths
(512 even, 333x517 odd) on the default device against plain numpy float64
implementations of the same semantics: edge-clamped 2x2 means, means of the
in-image samples, and nearest-neighbour upsampling.

Run: ``python tools/check_downscale_parity.py`` (exits non-zero on failure).
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _downscale_np(x):
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2)), mode="edge")
    return 0.25 * (xp[:, 0::2, 0::2] + xp[:, 1::2, 0::2] + xp[:, 0::2, 1::2]
                   + xp[:, 1::2, 1::2])


def _subsample_np(x):
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2)))
    cnt = np.pad(np.ones((h, w)), ((0, h % 2), (0, w % 2)))
    s = xp[:, 0::2, 0::2] + xp[:, 1::2, 0::2] + xp[:, 0::2, 1::2] + xp[:, 1::2, 1::2]
    n = cnt[0::2, 0::2] + cnt[1::2, 0::2] + cnt[0::2, 1::2] + cnt[1::2, 1::2]
    return s / n


def _supersample_np(res, sub):
    h, w = res.shape
    up = np.repeat(np.repeat(sub, 2, axis=0), 2, axis=1)[:h, :w]
    return 0.85 * res + 0.5 * up


def main() -> None:
    import jax
    import jax.numpy as jnp

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from codec_eval_tpu.kernels.blur import downscale_by_2

    ba = importlib.import_module("codec_eval_tpu.kernels.butteraugli")
    print(f"device: {jax.devices()[0]}")

    rng = np.random.default_rng(3)
    ok = True

    def cmp(name, got, want, tol):
        nonlocal ok
        got = np.asarray(got, np.float64)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6)))
        if rel > tol:
            ok = False
        print(f"{'OK ' if rel <= tol else 'FAIL'} {name:44s} max rel {rel:.3e}")

    for h, w in ((512, 512), (333, 517)):
        x = rng.uniform(0, 1, (3, h, w))  # linear-light planes
        xj = jnp.asarray(x, jnp.float32)
        x32 = np.asarray(xj, np.float64)
        cmp(f"downscale_by_2 {h}x{w}", jax.jit(downscale_by_2)(xj), _downscale_np(x32), 5e-6)
        cmp(f"_subsample2x {h}x{w}", jax.jit(ba._subsample2x)(xj), _subsample_np(x32), 5e-6)
        res = rng.normal(1, 0.3, (h, w))
        sub = rng.normal(1, 0.3, ((h + 1) // 2, (w + 1) // 2))
        rj, sj = jnp.asarray(res, jnp.float32), jnp.asarray(sub, jnp.float32)
        cmp(
            f"_add_supersampled2x {h}x{w}",
            jax.jit(ba._add_supersampled2x)(rj, sj),
            _supersample_np(np.asarray(rj, np.float64), np.asarray(sj, np.float64)),
            5e-6,
        )

    print("ALL OK" if ok else "FAILURES", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
