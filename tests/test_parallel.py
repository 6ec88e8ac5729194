"""Device-mesh parallelism tests on the virtual 8-device CPU mesh
(the reference has no distributed layer to mirror — SURVEY.md §2.5 — so
these validate the accelerator replacement directly)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from codec_eval_tpu.parallel import make_mesh, shard_batch, sharded_score_fn


def _pairs(n, h=48, w=48):
    rng = np.random.default_rng(0)
    refs = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    dists = np.clip(
        refs.astype(np.int16) + rng.integers(-8, 9, refs.shape), 0, 255
    ).astype(np.uint8)
    return refs, dists


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_unsharded():
    mesh = make_mesh(n_batch=4, n_space=2)
    refs, dists = _pairs(4)
    step = sharded_score_fn(mesh, dssim=False, butteraugli=False, spatial=True)
    per_pair, agg = step(
        shard_batch(mesh, refs, spatial=True), shard_batch(mesh, dists, spatial=True)
    )
    sharded_s2 = np.asarray(per_pair["ssimulacra2"])

    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2

    single = np.array(
        [float(ssimulacra2(jnp.asarray(r), jnp.asarray(d))) for r, d in zip(refs, dists)]
    )
    # Spatial sharding changes reduction order only.
    np.testing.assert_allclose(sharded_s2, single, rtol=1e-4, atol=1e-3)
    assert float(agg["mean_ssimulacra2"]) == pytest.approx(single.mean(), abs=1e-3)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_batch_only_mesh():
    mesh = make_mesh(n_batch=8, n_space=1)
    refs, dists = _pairs(8, 32, 32)
    step = sharded_score_fn(mesh, dssim=False, butteraugli=False, ssimulacra2=False)
    per_pair, agg = step(shard_batch(mesh, refs), shard_batch(mesh, dists))
    assert per_pair["psnr"].shape == (8,)
    assert np.isfinite(np.asarray(per_pair["psnr"])).all()


def test_mesh_shape_validation():
    with pytest.raises(AssertionError):
        make_mesh(n_batch=64, n_space=2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_score_pairs_sharded_buckets_and_padding():
    from codec_eval_tpu.parallel import score_pairs_sharded, make_mesh

    mesh = make_mesh(n_batch=4, n_space=1)
    rng = np.random.default_rng(1)
    pairs = []
    # Two shape buckets, neither count divisible by the batch axis (4).
    for shape in [(32, 32), (24, 40)]:
        for _ in range(3):
            ref = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
            dist = np.clip(
                ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255
            ).astype(np.uint8)
            pairs.append((ref, dist))
    out = score_pairs_sharded(
        pairs, mesh=mesh, dssim=False, butteraugli=False, ssimulacra2=False
    )
    assert len(out.per_pair) == 6
    assert all(np.isfinite(p["psnr"]) for p in out.per_pair)
    assert out.means["psnr"] == pytest.approx(
        np.mean([p["psnr"] for p in out.per_pair])
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_score_pairs_sharded_masked_mixed_sizes():
    """masked=True scores heterogeneous sizes in one padded-bucket program
    and matches the exact per-shape path."""
    from codec_eval_tpu.parallel import score_pairs_sharded, make_mesh

    mesh = make_mesh(n_batch=4, n_space=1)
    rng = np.random.default_rng(2)
    pairs = []
    for shape in [(32, 32), (24, 40), (17, 29)]:
        ref = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
        dist = np.clip(
            ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255
        ).astype(np.uint8)
        pairs.append((ref, dist))
    got = score_pairs_sharded(pairs, mesh=mesh, masked=True, granularity=32)
    exact = score_pairs_sharded(pairs, mesh=mesh)
    assert len(got.per_pair) == 3
    for g, e in zip(got.per_pair, exact.per_pair):
        assert set(g) == {"psnr", "ssimulacra2", "dssim", "butteraugli"}
        for k in g:
            assert g[k] == pytest.approx(e[k], rel=2e-3, abs=1e-4), (k, g, e)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_stage_then_score_matches_one_shot():
    """The staging/scoring split (host-overlap + device-only benchmarking)
    must produce exactly the one-shot result, staged buckets reusable."""
    from codec_eval_tpu.parallel import (
        make_mesh,
        score_pairs_sharded,
        score_staged,
        stage_pairs_sharded,
    )

    mesh = make_mesh(n_batch=4, n_space=1)
    rng = np.random.default_rng(4)
    pairs = []
    for shape in [(32, 32), (24, 40), (17, 29)]:
        ref = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
        dist = np.clip(
            ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255
        ).astype(np.uint8)
        pairs.append((ref, dist))
    for masked in (False, True):
        staged = stage_pairs_sharded(
            pairs, mesh=mesh, masked=masked, granularity=32
        )
        got = score_staged(staged)
        again = score_staged(staged)  # staged buckets are reusable
        want = score_pairs_sharded(
            pairs, mesh=mesh, masked=masked, granularity=32
        )
        assert got.per_pair == want.per_pair == again.per_pair
        assert got.means == want.means


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("masked", [False, True])
def test_staging_reuses_compiled_step(masked):
    """Two ``stage_pairs_sharded`` calls on one mesh must share ONE jitted
    step, and scoring the second slice must not retrace/recompile.

    Regression test for the per-staging-call recompilation bug: a fresh
    ``jax.jit`` closure per call carried a fresh executable cache, so every
    staged corpus slice paid full recompilation (~58.6s vs 0.21s reuse at toy
    sizes) — voiding the stage/score overlap pattern this split exists for.
    """
    from codec_eval_tpu.parallel import (
        make_mesh,
        score_staged,
        stage_pairs_sharded,
    )

    mesh = make_mesh(n_batch=4, n_space=1)
    rng = np.random.default_rng(11)

    def slice_pairs():
        pairs = []
        for shape in [(32, 32), (24, 40)]:
            ref = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
            dist = np.clip(
                ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255
            ).astype(np.uint8)
            pairs.append((ref, dist))
        return pairs

    staged1 = stage_pairs_sharded(slice_pairs(), mesh=mesh, masked=masked,
                                  granularity=32)
    score_staged(staged1)
    staged2 = stage_pairs_sharded(slice_pairs(), mesh=mesh, masked=masked,
                                  granularity=32)
    # Step identity: the jitted object (and with it, its executable cache)
    # is shared across staging calls.
    assert staged2.step is staged1.step
    n_compiled = staged1.step._cache_size()
    assert n_compiled > 0
    score_staged(staged2)
    # No new trace for the second slice's (same-shape) buckets.
    assert staged1.step._cache_size() == n_compiled


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_score_pairs_sharded_masked_metric_filter():
    from codec_eval_tpu.parallel import score_pairs_sharded, make_mesh

    mesh = make_mesh(n_batch=4, n_space=1)
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    out = score_pairs_sharded(
        [(ref, ref)], mesh=mesh, masked=True, granularity=32,
        dssim=False, butteraugli=False,
    )
    assert set(out.per_pair[0]) == {"psnr", "ssimulacra2"}
    assert out.per_pair[0]["ssimulacra2"] == 100.0
