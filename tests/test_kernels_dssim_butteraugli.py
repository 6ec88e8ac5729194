"""DSSIM + Butteraugli kernel tests: brackets and golden tracking.

Mirrors the reference's bracket assertions (src/metrics/dssim.rs:180-249,
src/metrics/butteraugli.rs:168-197) plus golden-oracle comparison against
the system libjxl butteraugli where available.
"""

import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image

from codec_eval_tpu.kernels import butteraugli as ba
from codec_eval_tpu.kernels.butteraugli import butteraugli
from codec_eval_tpu.kernels.color import srgb_u8_to_linear
from codec_eval_tpu.kernels.dssim import dssim, dssim_u8
from codec_eval_tpu.utils import jxl_golden


def _photo(w=96, h=96, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 68 * np.sin(x / 13.0) + 52 * np.cos(y / 9.0)
    img = np.stack([base, base * 0.88 + 12, base * 0.74 + 26], -1)
    return np.clip(img + rng.normal(0, 7, img.shape), 0, 255).astype(np.uint8)


def _jpeg(img, q):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=q)
    return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


# -- DSSIM ----------------------------------------------------------------


def test_dssim_identical_zero():
    img = _photo()
    assert float(dssim_u8(jnp.asarray(img), jnp.asarray(img))) == 0.0


def test_dssim_monotone_with_quality():
    img = _photo()
    values = [
        float(dssim_u8(jnp.asarray(img), jnp.asarray(_jpeg(img, q))))
        for q in (30, 60, 90)
    ]
    assert values[0] > values[1] > values[2] > 0


def test_dssim_heavy_distortion_large():
    img = _photo()
    noise = np.random.default_rng(2).integers(0, 256, img.shape).astype(np.uint8)
    bad = float(dssim_u8(jnp.asarray(img), jnp.asarray(noise)))
    good = float(dssim_u8(jnp.asarray(img), jnp.asarray(_jpeg(img, 90))))
    assert bad > good * 5


def test_dssim_accepts_planes_or_hwc():
    img = _photo(48, 48)
    dist = _jpeg(img, 70)
    lin1 = srgb_u8_to_linear(jnp.asarray(img))
    lin2 = srgb_u8_to_linear(jnp.asarray(dist))
    hwc = float(dssim(lin1, lin2))
    chw = float(dssim(jnp.moveaxis(lin1, -1, 0), jnp.moveaxis(lin2, -1, 0)))
    assert hwc == pytest.approx(chw, rel=1e-5)


# -- Butteraugli ----------------------------------------------------------


def test_butteraugli_identical_zero():
    img = _photo()
    assert float(butteraugli(jnp.asarray(img), jnp.asarray(img))) == 0.0


def test_butteraugli_monotone_with_quality():
    img = _photo()
    values = [
        float(butteraugli(jnp.asarray(img), jnp.asarray(_jpeg(img, q))))
        for q in (30, 60, 90)
    ]
    assert values[0] > values[2] > 0


@pytest.mark.skipif(not jxl_golden.is_available(), reason="libjxl unavailable")
def test_butteraugli_tracks_golden():
    """Faithful port stays within 3% of the live canonical scorer on a JPEG
    sweep plus noise (the committed-fixture distribution gate lives in
    tests/test_butteraugli_oracle.py; this is the live-oracle spot check)."""
    img = _photo(128, 128)
    pairs = [_jpeg(img, q) for q in (30, 50, 70, 90)]
    rng = np.random.default_rng(3)
    pairs.append(
        np.clip(img.astype(np.int16) + rng.integers(-10, 11, img.shape), 0, 255
                ).astype(np.uint8)
    )
    mine, gold = [], []
    for dist in pairs:
        mine.append(float(butteraugli(jnp.asarray(img), jnp.asarray(dist))))
        gold.append(jxl_golden.butteraugli_golden(img, dist))
    mine, gold = np.array(mine), np.array(gold)
    rel = np.abs(mine - gold) / np.maximum(gold, 1e-9)
    assert rel.max() < 0.03, (mine, gold, rel)


def test_butteraugli_intensity_target_plumbing():
    """Higher intensity target -> artifacts in shadows more visible
    (scores change; parameter is live).
    reference: src/metrics/butteraugli.rs:99-135."""
    img = _photo()
    dist = _jpeg(img, 50)
    d80 = float(butteraugli(jnp.asarray(img), jnp.asarray(dist), intensity_target=80.0))
    d250 = float(butteraugli(jnp.asarray(img), jnp.asarray(dist), intensity_target=250.0))
    assert d80 != d250


def test_dssim_image_helpers():
    """rgb8/rgba8 -> linear-light RGBA f32 staging helpers
    (reference: src/metrics/dssim.rs:102-148)."""
    import numpy as np

    from codec_eval_tpu.metrics import rgb8_to_dssim_image, rgba8_to_dssim_image

    rgb = np.array([0, 128, 255, 10, 20, 30], np.uint8)
    out = rgb8_to_dssim_image(rgb, 2, 1)
    assert out.shape == (1, 2, 4) and out.dtype == np.float32
    s = 128 / 255.0
    assert out[0, 0, 1] == pytest.approx(((s + 0.055) / 1.055) ** 2.4, abs=1e-5)
    assert out[0, 0, 0] == 0.0 and out[0, 0, 2] == 1.0
    assert np.all(out[..., 3] == 1.0)

    rgba = np.array([0, 128, 255, 64, 10, 20, 30, 255], np.uint8)
    o2 = rgba8_to_dssim_image(rgba, 2, 1)
    assert o2[0, 0, 3] == pytest.approx(64 / 255.0)
    assert np.allclose(o2[..., :3], out[..., :3], atol=1e-6)


def test_malta_stack_xla_matches_percall_sweeps():
    """The stacked formulation reproduces the six individual _malta_diff_map
    calls of _diffmap_psycho exactly (same prologue, same sweeps)."""
    rng = np.random.default_rng(4)
    h = w = 40

    def pi(seed):
        r = np.random.default_rng(seed)
        return ba.PsychoImage(
            uhf=jnp.asarray(r.normal(0, 1, (2, h, w)).astype(np.float32)),
            hf=jnp.asarray(r.normal(0, 1, (2, h, w)).astype(np.float32)),
            mf=jnp.asarray(r.normal(0, 1, (3, h, w)).astype(np.float32)),
            lf=jnp.asarray(r.normal(0, 1, (3, h, w)).astype(np.float32)),
        )

    pi0, pi1 = pi(1), pi(2)
    a = 0.8
    stack = ba._malta_diffs_stack(pi0, pi1, a)
    got = np.asarray(ba._malta_ac_stack_xla(stack))

    aj = jnp.float32(a)
    sqrt_a = jnp.sqrt(aj)
    ac1 = ba._malta_diff_map(
        pi0.uhf[1], pi1.uhf[1], ba._W_UHF_MALTA * aj, ba._W_UHF_MALTA / aj,
        ba._NORM1_UHF, ba._MALTA_MULLI, ba._MALTA_LINES_FULL)
    ac0 = ba._malta_diff_map(
        pi0.uhf[0], pi1.uhf[0], ba._W_UHF_MALTA_X * aj, ba._W_UHF_MALTA_X / aj,
        ba._NORM1_UHF_X, ba._MALTA_MULLI, ba._MALTA_LINES_FULL)
    ac1 = ac1 + ba._malta_diff_map(
        pi0.hf[1], pi1.hf[1], ba._W_HF_MALTA * sqrt_a, ba._W_HF_MALTA / sqrt_a,
        ba._NORM1_HF, ba._MALTA_MULLI_LF, ba._MALTA_LINES_LF)
    ac0 = ac0 + ba._malta_diff_map(
        pi0.hf[0], pi1.hf[0], ba._W_HF_MALTA_X * sqrt_a, ba._W_HF_MALTA_X / sqrt_a,
        ba._NORM1_HF_X, ba._MALTA_MULLI_LF, ba._MALTA_LINES_LF)
    ac1 = ac1 + ba._malta_diff_map(
        pi0.mf[1], pi1.mf[1], ba._W_MF_MALTA, ba._W_MF_MALTA,
        ba._NORM1_MF, ba._MALTA_MULLI_LF, ba._MALTA_LINES_LF)
    ac0 = ac0 + ba._malta_diff_map(
        pi0.mf[0], pi1.mf[0], ba._W_MF_MALTA_X, ba._W_MF_MALTA_X,
        ba._NORM1_MF_X, ba._MALTA_MULLI_LF, ba._MALTA_LINES_LF)
    want = np.stack([np.asarray(ac0), np.asarray(ac1)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_butteraugli_batch_matches_single():
    rng = np.random.default_rng(5)
    h = w = 32
    ref = rng.integers(0, 256, (h, w, 3), np.uint8)
    batch = np.stack(
        [
            np.clip(
                ref.astype(np.int16) + rng.integers(-25, 26, ref.shape), 0, 255
            ).astype(np.uint8)
            for _ in range(2)
        ]
    )
    pre = ba.precompute_butteraugli_reference(jnp.asarray(ref))
    want = np.array(
        [
            float(ba.butteraugli_against_reference(pre, jnp.asarray(d)))
            for d in batch
        ]
    )
    got = np.asarray(ba.butteraugli_batch(pre, jnp.asarray(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
