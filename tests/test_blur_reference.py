"""The metric stencils against plain float64 numpy references.

The blurs, the pyramid steps and the Malta line sums are the formulations
XLA compiles for every backend; each is checked here against an
independent numpy implementation at odd and even shapes.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from codec_eval_tpu.kernels.blur import blur_separable, downscale_by_2, gaussian_taps

# The kernels package re-exports functions that shadow this module's name.
ba = importlib.import_module("codec_eval_tpu.kernels.butteraugli")

ODD_SHAPES = [(37, 53), (64, 41), (9, 130)]


def _fir_zero_np(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """out[i] = sum_k taps[k] * x[i + k - r], zero outside the array."""
    r = len(taps) // 2
    n = x.shape[axis]
    out = np.zeros_like(x)
    for k, t in enumerate(taps.astype(np.float64)):
        d = k - r
        src = [slice(None)] * x.ndim
        dst = [slice(None)] * x.ndim
        src[axis] = slice(max(0, d), min(n, n + d))
        dst[axis] = slice(max(0, -d), min(n, n - d))
        out[tuple(dst)] += t * x[tuple(src)]
    return out


def _renorm_blur_np(x: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    """Butteraugli's border-renormalised truncated Gaussian along one axis."""
    radius = max(1, int(2.25 * sigma))
    w = np.exp(-np.arange(-radius, radius + 1) ** 2 / (2.0 * sigma * sigma))
    num = _fir_zero_np(x, w, axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    den = _fir_zero_np(np.ones(shape), w, axis)
    return num / den


@pytest.mark.parametrize("shape", ODD_SHAPES)
@pytest.mark.parametrize("sigma", [1.5, 1.53], ids=["ssim2", "dssim"])
def test_blur_separable_matches_float64_fir(shape, sigma):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2,) + shape)
    taps = gaussian_taps(sigma).astype(np.float64)
    want = _fir_zero_np(_fir_zero_np(x, taps, 1), taps, 2)
    got = np.asarray(jax.jit(lambda p: blur_separable(p, sigma))(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("form", ["dense", "banded"])
@pytest.mark.parametrize(
    "sigma", [ba.SIGMA_LF, ba.SIGMA_MASK, ba.SIGMA_UHF], ids=["lf", "mask", "hf"]
)
@pytest.mark.parametrize("batched", [False, True], ids=["planes", "batch"])
def test_butteraugli_blur_matches_float64(monkeypatch, form, sigma, batched):
    # 256 = two 128-blocks: the banded form is taken when the gate allows 2.
    monkeypatch.setattr(ba, "_BANDED_MIN_BLOCKS", 2 if form == "banded" else 10**6)
    h, w = 256, 384
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 3, h, w))
    want = _renorm_blur_np(_renorm_blur_np(x, sigma, 2), sigma, 3)
    xj = jnp.asarray(x, jnp.float32)
    if batched:  # one contraction over the (B, C) leading axes
        got = jax.jit(lambda p: ba._blur(p, sigma))(xj)
    else:
        got = jax.jit(jax.vmap(lambda p: ba._blur(p, sigma)))(xj)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=3e-6)


def _downscale_np(x: np.ndarray) -> np.ndarray:
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2)), mode="edge")
    return 0.25 * (xp[:, 0::2, 0::2] + xp[:, 1::2, 0::2] + xp[:, 0::2, 1::2]
                   + xp[:, 1::2, 1::2])


def _subsample_np(x: np.ndarray) -> np.ndarray:
    """Mean of the in-image samples of every 2x2 block."""
    c, h, w = x.shape
    out = np.zeros((c, (h + 1) // 2, (w + 1) // 2))
    for i in range(out.shape[1]):
        for j in range(out.shape[2]):
            out[:, i, j] = x[:, 2 * i : 2 * i + 2, 2 * j : 2 * j + 2].mean(axis=(1, 2))
    return out


def _supersample_np(result: np.ndarray, sub: np.ndarray) -> np.ndarray:
    h, w = result.shape
    up = np.array([[sub[i // 2, j // 2] for j in range(w)] for i in range(h)])
    return 0.85 * result + 0.5 * up


@pytest.mark.parametrize("shape", [(32, 48), (33, 47)], ids=["even", "odd"])
@pytest.mark.parametrize("op", ["downscale_by_2", "subsample2x", "supersample2x"])
def test_pyramid_steps_match_numpy(shape, op):
    rng = np.random.default_rng(2)
    h, w = shape
    x = rng.uniform(0, 1, (3, h, w))
    xj = jnp.asarray(x, jnp.float32)
    if op == "downscale_by_2":
        got, want = downscale_by_2(xj), _downscale_np(x)
    elif op == "subsample2x":
        got, want = ba._subsample2x(xj), _subsample_np(x)
    else:
        sub = rng.uniform(0, 1, ((h + 1) // 2, (w + 1) // 2))
        got = ba._add_supersampled2x(xj[0], jnp.asarray(sub, jnp.float32))
        want = _supersample_np(x[0], sub)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-6)


def _malta_np(diffs: np.ndarray, lines) -> np.ndarray:
    """Direct loop: per pixel, per line, square the in-image sample sum."""
    h, w = diffs.shape
    out = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            acc = 0.0
            for weight, line in lines:
                s = 0.0
                for dy, dx in line:
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < h and 0 <= xx < w:
                        s += diffs[yy, xx]
                acc += weight * s * s
            out[y, x] = acc
    return out


@pytest.mark.parametrize("pattern", ["full", "lf"])
@pytest.mark.parametrize("shape", [(13, 17), (20, 9)])
def test_malta_sweep_matches_numpy_line_loop(pattern, shape):
    lines = ba._MALTA_LINES_FULL if pattern == "full" else ba._MALTA_LINES_LF
    rng = np.random.default_rng(3)
    d = rng.normal(0, 1, shape)
    got = np.asarray(ba._malta_sweep(jnp.asarray(d, jnp.float32), lines))
    want = _malta_np(d, lines)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # Every line of both patterns is symmetric about its centre sample.
    for _w, line in lines:
        assert sorted((-dy, -dx) for dy, dx in line) == sorted(line)
        assert (0, 0) in line
    assert math.isclose(sum(w for w, _ in lines), 16.0)


@pytest.mark.parametrize("masked", [False, True])
def test_fuzzy_erosion_matches_sorted_candidates(masked):
    """The three smallest of {v, 2v, 2v, 8 step-3 neighbours} against a
    numpy sort of the same candidates."""
    rng = np.random.default_rng(4)
    h, w = 14, 19
    v = rng.uniform(0, 2, (h, w))
    mask = np.zeros((h, w))
    mask[: h - 3, : w - 5] = 1.0
    big = np.float32(np.finfo(np.float32).max / 4)
    src = np.where(mask > 0, v, big) if masked else v
    padded = np.pad(src, 3, constant_values=big)
    cands = [v, 2 * v, 2 * v] + [
        padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
        for dy in (-3, 0, 3) for dx in (-3, 0, 3) if (dy, dx) != (0, 0)
    ]
    m = np.sort(np.stack(cands), axis=0)
    want = 0.45 * m[0] + 0.3 * m[1] + 0.25 * m[2]
    vj = jnp.asarray(v, jnp.float32)
    got = ba._fuzzy_erosion(vj, jnp.asarray(mask, jnp.float32) if masked else None)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)
