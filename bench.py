"""Benchmark: scoring throughput on one GPU.

The default scenario measures SSIMULACRA2 scoring at 800px (images/s, the
north-star metric from BASELINE.md): one source image's reference pyramid is
precomputed once, then a dense sweep of 25 distorted candidates is scored
against it as one fused, jitted batch — the reference's hot loop
(crates/codec-iter/src/eval.rs:133-170).  ``vs_baseline`` compares against
the reference's own accelerator path, CUDA fast-ssim2 at ~4x its CPU speed
(crates/codec-iter/src/main.rs:70): from the published quick-eval envelope
(~360 ms for 9 512px encode+score iterations, README.md:96) the CPU scorer
is ~25 ms/pair at 512px => ~61 ms at 800px => ~16 img/s CPU, ~65 img/s with
CUDA.

``--scenario sweep`` (also folded into the default run's "sweep" field)
measures the dense 25-point x 4-codec sweep at 512px with real codec
artifacts (PIL 420/444/progressive JPEG + WebP): all-metric and
SSIMULACRA2-only scored pairs/s, the device-resident tpujpeg ladder, device
JPEG decode, and an end-to-end rate with host encode/decode overlapped with
device scoring.  ``--scenario large`` measures the 2048px CLIC-class chunk
and the masked mixed-size corpus.

Every rate is the median of repeated timed windows, each ended by
``block_until_ready``; the spread of the repeats is reported beside it.
The record names the card (name and power limit, from nvidia-smi) and the
JAX device it ran on.  The bench refuses to run without a GPU, and exits
non-zero when any scenario recorded an error.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASELINE_IMAGES_PER_SEC = 65.0  # reference CUDA ssimulacra2 at 800px (see above)
SIZE = 800
SWEEP = 25  # dense quality preset: (50..=98).step_by(2)
REPS = 3


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (
        118
        + 68 * np.sin(x / 13.0)
        + 52 * np.cos(y / 9.0)
        + 24 * np.sin((x + y) / 31.0)
    )
    img = np.stack([base, base * 0.88 + 12, base * 0.74 + 26], -1)
    img = img + rng.normal(0, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


SWEEP_SIZE = 512
SWEEP_IMAGES = int(os.environ.get("CODEC_EVAL_BENCH_IMAGES", "8"))
SWEEP_IMAGES_E2E = 4
SWEEP_QUALITIES = tuple(range(50, 99, 2))  # dense preset: 25 points


def _median_spread(vals):
    """(median, {"min", "max", "n"}) of a field's repeated measurements."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None, None
    return statistics.median(vals), {
        "min": min(vals), "max": max(vals), "n": len(vals)
    }


def _timed(fn) -> float:
    """Wall seconds of ``fn()``, whose result is waited for on device."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def _sweep_codecs():
    """The 4-codec ladder of the flagship scenario, as PIL encode/decode
    callbacks (the reference's mozjpeg 420/444/prog + webp analog)."""
    from PIL import Image

    def roundtrip(img, fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **kw)
        return np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))

    return {
        "jpeg-420": lambda img, q: roundtrip(
            img, "JPEG", quality=q, subsampling=2
        ),
        "jpeg-444": lambda img, q: roundtrip(
            img, "JPEG", quality=q, subsampling=0
        ),
        "jpeg-420-prog": lambda img, q: roundtrip(
            img, "JPEG", quality=q, subsampling=2, progressive=True
        ),
        "webp": lambda img, q: roundtrip(img, "WEBP", quality=q),
    }


def run_sweep_scenario(jax, jnp) -> dict:
    """BASELINE.md flagship: dense 25-pt x 4-codec all-metric sweep at 512px."""
    from codec_eval_tpu.engine.scoring import (
        _build_chunk_scorer,
        _build_precompute,
    )

    refs = [_photo(SWEEP_SIZE, SWEEP_SIZE, 100 + i) for i in range(SWEEP_IMAGES)]
    codecs = _sweep_codecs()
    n_cand = len(codecs) * len(SWEEP_QUALITIES)

    def encode_image(ref):
        return np.stack(
            [fn(ref, q) for fn in codecs.values() for q in SWEEP_QUALITIES]
        )

    # Host codec pass (untimed here; measured separately in the e2e phase).
    with ThreadPoolExecutor(max_workers=8) as pool:
        cand_batches = list(pool.map(encode_image, refs))

    # The reference-side work (pyramids, psycho images, masking) runs once
    # per image in its own program; candidates are scored in chunks of 25
    # (four dispatches cover the 4-codec x 25-quality grid with no padding).
    chunk = int(os.environ.get("CODEC_EVAL_BENCH_CHUNK", "25"))
    n_chunks = n_cand // chunk
    # Candidates are staged planar (N, 3, H, W) u8, matching the production
    # engine (BatchScorer.score_batch).
    scorer_all = _build_chunk_scorer(
        SWEEP_SIZE, SWEEP_SIZE, chunk, True, True, True, True, planar=True
    )
    scorer_s2 = _build_chunk_scorer(
        SWEEP_SIZE, SWEEP_SIZE, chunk, False, True, False, False, planar=True
    )
    pre_all = _build_precompute(SWEEP_SIZE, SWEEP_SIZE, True, True, True, False)
    pre_s2 = _build_precompute(SWEEP_SIZE, SWEEP_SIZE, False, True, False, False)
    refs_dev = [jnp.asarray(r) for r in refs]
    chunks = [
        [
            np.ascontiguousarray(
                np.moveaxis(batch[c * chunk : (c + 1) * chunk], -1, 1)
            )
            for c in range(n_chunks)
        ]
        for batch in cand_batches
    ]

    def timed_pairs_per_sec(scorer, pre_fn):
        """(device-resident, with-staging) pairs/s over REPS windows.

        The device-resident window times the dispatch chain over inputs
        already on device — per image one reference precompute plus
        ``n_chunks`` chunk dispatches.  The staging window also includes
        the host->device transfers of every chunk.
        """
        jax.block_until_ready(scorer(pre_fn(refs_dev[0]), jnp.asarray(chunks[0][0])))
        resident, staged = [], []
        for _ in range(REPS):
            t_stage = time.perf_counter()
            devs = jax.block_until_ready(
                [jnp.asarray(c) for per_img in chunks for c in per_img]
            )
            t0 = time.perf_counter()

            def chain():
                outs = []
                for i in range(SWEEP_IMAGES):
                    pre = pre_fn(refs_dev[i])
                    for c in range(n_chunks):
                        outs.append(scorer(pre, devs[i * n_chunks + c]))
                return outs

            jax.block_until_ready(chain())
            t1 = time.perf_counter()
            resident.append(SWEEP_IMAGES * n_cand / (t1 - t0))
            staged.append(SWEEP_IMAGES * n_cand / (t1 - t_stage))
        return resident, staged

    all_vals, all_staged_vals = timed_pairs_per_sec(scorer_all, pre_all)
    s2_vals, _ = timed_pairs_per_sec(scorer_s2, pre_s2)

    # Device-resident tpujpeg ladder: encode (transform+quantize), decode
    # (dequant+iDCT+upsample) and all-metric scoring all on device — no
    # candidate pixels cross the host boundary (engine/tpu_sweep.py).  The
    # reference has no analog: its loop round-trips every candidate through
    # host RAM (crates/codec-iter/src/eval.rs:151-167).  Three size modes:
    # "scores" skips rate work entirely; "device" reduces each ladder to
    # packed symbol histograms on device (kernels/jpeg_rate.py — entropy-
    # exact byte sizes, stuffing estimated, one small fetch per image);
    # "exact" fetches coefficient planes and entropy-codes exact .jpg bytes
    # on the host.
    def build_ladder_runner():
        from codec_eval_tpu.kernels import jpeg_enc as _je2
        from codec_eval_tpu.kernels import jpeg_rate as _jr
        from codec_eval_tpu.engine.tpu_sweep import _qtabs_for
        from codec_eval_tpu.utils import native as _nat

        qualities = [float(q) for q in SWEEP_QUALITIES]
        n_q = len(qualities)
        qtabs = jnp.asarray(_qtabs_for(qualities))
        scorer_p = _build_chunk_scorer(
            SWEEP_SIZE, SWEEP_SIZE, n_q, True, True, True, True, planar=True
        )
        recons = {
            wc: _je2.build_reconstruct_sweep(
                SWEEP_SIZE, SWEEP_SIZE, n_q, "420",
                planar_candidates=True, with_coefs=wc,
            )
            for wc in (False, True)
        }
        stats_fn = _jr.build_ladder_rate_stats("420")
        n_img = 4
        images = [
            jnp.asarray(_photo(SWEEP_SIZE, SWEEP_SIZE, 7000 + i))
            for i in range(n_img)
        ]

        def ladder(ref_dev, mode):
            cands, coefs = recons[mode != "scores"](ref_dev, qtabs, 0.30)
            scores = scorer_p(pre_all(ref_dev), cands)
            if mode == "device":
                coefs = stats_fn(coefs["y"], coefs["cb"], coefs["cr"])
            return scores, coefs

        for mode in ("exact", "scores", "device"):  # warm every compile
            jax.block_until_ready(ladder(images[0], mode))

        def run(mode):
            t0 = time.perf_counter()
            outs = []
            stats = []
            for img in images:
                scores, coefs = ladder(img, mode)
                outs.append(scores)
                if mode == "device":
                    stats.append(coefs)  # device arrays; fetched at the end
                elif mode == "exact":
                    cy = np.asarray(coefs["y"])
                    ccb = np.asarray(coefs["cb"])
                    ccr = np.asarray(coefs["cr"])
                    for qi, q in enumerate(qualities):
                        tl, tc = _je2.quality_to_qtables(q)
                        _nat.jpeg_encode_baseline(
                            SWEEP_SIZE, SWEEP_SIZE, "420",
                            cy[qi], ccb[qi], ccr[qi],
                            tl[_je2.ZIGZAG], tc[_je2.ZIGZAG],
                        )
            if mode == "device":
                packed = np.asarray(jnp.stack(stats))  # ONE fetch
                for im in packed:
                    _jr.size_estimates_from_packed(im)
            jax.block_until_ready(outs)
            return n_img * n_q / (time.perf_counter() - t0)

        return run

    ladder_run = build_ladder_runner()

    # Device-decode scoring of externally-encoded JPEGs: the host runs only
    # the Huffman parse (native/jpeg_huff_decode.cpp); dequant + iDCT +
    # upsample + all-metric scoring run on device
    # (codecs/jpeg_device.score_jpeg_files).
    def build_jpeg_device_runner():
        from PIL import Image as _Image

        from codec_eval_tpu.codecs import jpeg_device as _jd

        if not _jd.is_available():
            return None
        n_img = 3

        def ladder(img):
            out = []
            for q in SWEEP_QUALITIES:
                b = io.BytesIO()
                _Image.fromarray(img).save(b, "JPEG", quality=int(q))
                out.append(b.getvalue())
            return out

        refs_j = [_photo(SWEEP_SIZE, SWEEP_SIZE, 7700 + i) for i in range(n_img)]
        ladders = [ladder(r) for r in refs_j]
        _ = _jd.score_jpeg_files(refs_j[0], ladders[0])  # warm

        def run():
            t0 = time.perf_counter()
            for r, lad in zip(refs_j, ladders):
                _ = _jd.score_jpeg_files(r, lad)
            return n_img * len(SWEEP_QUALITIES) / (time.perf_counter() - t0)

        return run

    jpeg_dev_run = build_jpeg_device_runner()

    # End-to-end: host encode/decode overlapped with device scoring via a
    # producer pool + async dispatch (SURVEY.md §7 hard part #2).
    def e2e_once():
        n_e2e = min(SWEEP_IMAGES_E2E, len(refs))
        t0 = time.perf_counter()
        outs = []
        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(encode_image, r) for r in refs[:n_e2e]]
            for i, fut in enumerate(futures):
                batch = fut.result()
                pre = pre_all(refs_dev[i])
                for c in range(n_chunks):
                    planar = np.ascontiguousarray(
                        np.moveaxis(batch[c * chunk : (c + 1) * chunk], -1, 1)
                    )
                    outs.append(scorer_all(pre, jnp.asarray(planar)))
        jax.block_until_ready(outs)
        return n_e2e * n_cand / (time.perf_counter() - t0)

    # Repetitions interleaved round-robin across fields, so a slow phase of
    # the host or card shows in every field's spread instead of one field.
    ladder_vals = {"scores": [], "device": [], "exact": []}
    e2e_vals: list = []
    jpeg_vals: list = []
    for _rep in range(REPS):
        for mode in ("scores", "device", "exact"):
            ladder_vals[mode].append(ladder_run(mode))
        e2e_vals.append(e2e_once())
        if jpeg_dev_run is not None:
            jpeg_vals.append(jpeg_dev_run())

    fields = {
        "allmetric_pairs_per_sec": all_vals,
        "allmetric_with_staging_pairs_per_sec": all_staged_vals,
        "ssim2_only_pairs_per_sec": s2_vals,
        # Bounded by host codec throughput: PIL encode/decode gets
        # host_cpu_count cores.
        "e2e_overlapped_pairs_per_sec": e2e_vals,
        "device_ladder_exact_sizes_pairs_per_sec": ladder_vals["exact"],
        "device_ladder_device_sizes_pairs_per_sec": ladder_vals["device"],
        "device_ladder_scores_only_pairs_per_sec": ladder_vals["scores"],
        "jpeg_device_decode_score_pairs_per_sec": jpeg_vals,
    }
    out: dict = {}
    spread: dict = {}
    for name, vals in fields.items():
        out[name], spread[name] = _median_spread(vals)

    # Achieved FLOP/s from XLA's cost analysis of the chunk program.
    flops = None
    try:
        lowered = scorer_all.lower(
            pre_all(refs_dev[0]), jnp.asarray(chunks[0][0])
        )
        analysis = lowered.compile().cost_analysis()
        if isinstance(analysis, (list, tuple)):
            analysis = analysis[0]
        flops = float(analysis.get("flops", 0.0)) or None
    except Exception:
        pass
    out["achieved_tflops"] = (
        flops * out["allmetric_pairs_per_sec"] / chunk / 1e12 if flops else None
    )
    out["host_cpu_count"] = os.cpu_count()
    out["spread"] = spread
    return out


LARGE_SIZE = 2048
LARGE_QUALITIES = tuple(range(50, 99, 5))  # 10-point ladder


def run_large_scenario(jax, jnp) -> dict:
    """CLIC-class scenario (2048px, the reference's CLIC2025 calibration
    size — src/stats/rd_knee.rs:1049-1084) plus a mixed-size masked-bucket
    corpus."""
    from codec_eval_tpu.engine.scoring import (
        _build_chunk_scorer,
        _build_precompute,
    )

    chunk = int(os.environ.get("CODEC_EVAL_BENCH_LARGE_CHUNK", "5"))
    n_cand = len(LARGE_QUALITIES)
    n_chunks = n_cand // chunk
    # Three distinct reference images per timed window.
    n_img = 3
    refs = [_photo(LARGE_SIZE, LARGE_SIZE, 900 + i) for i in range(n_img)]
    codecs = _sweep_codecs()

    def encode_ladder(r, fn):
        return np.stack([fn(r, q) for q in LARGE_QUALITIES])

    with ThreadPoolExecutor(max_workers=4) as pool:
        batches = list(
            pool.map(lambda r: encode_ladder(r, codecs["jpeg-420"]), refs)
        )

    scorer = _build_chunk_scorer(
        LARGE_SIZE, LARGE_SIZE, chunk, True, True, True, True, planar=True
    )
    pre = _build_precompute(LARGE_SIZE, LARGE_SIZE, True, True, True, False)
    refs_dev = jax.block_until_ready([jnp.asarray(r) for r in refs])
    img_chunks = jax.block_until_ready(
        [
            [
                jnp.asarray(
                    np.ascontiguousarray(
                        np.moveaxis(batch[c * chunk : (c + 1) * chunk], -1, 1)
                    )
                )
                for c in range(n_chunks)
            ]
            for batch in batches
        ]
    )

    warm = scorer(pre(refs_dev[0]), img_chunks[0][0])
    warm_np = {k: np.asarray(v) for k, v in warm.items()}
    assert all(np.isfinite(v).all() for v in warm_np.values()), warm_np

    def window():
        outs = []
        for i in range(n_img):
            p = pre(refs_dev[i])
            outs.extend(scorer(p, c) for c in img_chunks[i])
        return outs

    pairs_2048 = [n_img * n_cand / _timed(window) for _ in range(REPS)]

    # Mixed-size masked buckets (512/800/2048 in ONE corpus run) through the
    # production sharded runner — wall-clock includes staging, one device.
    from codec_eval_tpu.parallel.corpus_runner import (
        score_pairs_sharded,
        score_staged,
        stage_pairs_sharded,
    )
    from codec_eval_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_batch=len(jax.devices()), n_space=1)

    def make_mixed(seed0):
        out = []
        for size, n in ((512, 4), (800, 2), (2048, 1)):
            for i in range(n):
                r = _photo(size, size, seed0 + i)
                out.append((r, codecs["jpeg-420"](r, 75)))
        return out

    mixed = make_mixed(970)
    # Warm pass compiles the three bucket programs.
    score_pairs_sharded(mixed, mesh=mesh, masked=True, granularity=128)
    wall_vals = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = score_pairs_sharded(mixed, mesh=mesh, masked=True, granularity=128)
        wall_vals.append(len(mixed) / (time.perf_counter() - t0))
    assert all(
        0.0 < row["ssimulacra2"] <= 100.0 for row in res.per_pair
    ), res.per_pair

    # Device-only rate: stage once, then time only the score_staged passes.
    staged = stage_pairs_sharded(mixed, mesh=mesh, masked=True, granularity=128)
    jax.block_until_ready([b[1:3] for b in staged.buckets])
    dev_vals = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        score_staged(staged)
        dev_vals.append(len(mixed) / (time.perf_counter() - t0))

    out = {}
    spread = {}
    for name, vals in (
        ("pairs_per_sec_2048px_allmetric", pairs_2048),
        ("masked_mixed_size_pairs_per_sec_wall", wall_vals),
        ("masked_mixed_device_pairs_per_sec", dev_vals),
    ):
        out[name], spread[name] = _median_spread(vals)
    out["masked_mixed_sizes"] = "4x512 + 2x800 + 1x2048, granularity 128"
    out["large_chunk"] = chunk
    out["spread"] = spread
    return out


def run_precompute_scenario(jax, jnp) -> dict:
    """North-star 800px SSIMULACRA2 throughput (BASELINE.md)."""
    from codec_eval_tpu.kernels.ssimulacra2 import (
        precompute_reference,
        ssimulacra2_batch_pre,
    )

    rng = np.random.default_rng(1)
    ref = _photo(SIZE, SIZE, 0)
    dists = np.stack(
        [
            np.clip(
                ref.astype(np.int16)
                + rng.integers(-q // 4 - 2, q // 4 + 3, ref.shape),
                0,
                255,
            ).astype(np.uint8)
            for q in range(SWEEP)
        ]
    )
    inputs = jax.block_until_ready((jnp.asarray(ref), jnp.asarray(dists)))

    @jax.jit
    def sweep(ref_u8, batch_u8):
        pre = precompute_reference(ref_u8)
        return ssimulacra2_batch_pre(pre, ref_u8, batch_u8)

    # Warmup / compile — and a correctness guard so a perf regression can
    # never hide behind wrong results: scores must be finite, <= 100, and an
    # identical pair must score exactly 100.
    warm = np.asarray(sweep(*inputs))
    assert np.isfinite(warm).all() and (warm <= 100.0).all(), warm
    # The raw feature path (no byte-equality fast path) carries ~0.05 of
    # float asymmetry between the precompute and candidate stacks; the guard
    # catches garbage, not bit-exactness.
    ident = np.asarray(sweep(inputs[0], jnp.broadcast_to(inputs[0], inputs[1].shape)))
    assert np.allclose(ident, 100.0, atol=0.2), ident[:3]

    # Optional jax.profiler capture: CODEC_EVAL_TRACE_DIR=<dir>
    from codec_eval_tpu.utils.profiling import device_trace

    chain = 3
    vals = []
    with device_trace(os.environ.get("CODEC_EVAL_TRACE_DIR")):
        for _ in range(REPS):
            t = _timed(lambda: [sweep(*inputs) for _ in range(chain)])
            vals.append(SWEEP * chain / t)
    images_per_sec, spread = _median_spread(vals)
    return {
        "value": images_per_sec,
        "vs_baseline": images_per_sec / BASELINE_IMAGES_PER_SEC,
        "spread": spread,
    }


def _guarded(fn, *args) -> dict:
    """Fault isolation: one scenario's failure must not void the others'
    already-computed numbers.  Returns the scenario dict, or {"error": ...}."""
    import traceback

    try:
        return fn(*args)
    except Exception:
        tb = traceback.format_exc(limit=40)
        lines = [
            ln
            for ln in tb.strip().splitlines()
            if ln.strip()
            and "JAX has removed its internal frames" not in ln
            and "JAX_TRACEBACK_FILTERING" not in ln
            and not ln.startswith("-")
        ]
        line = (lines[-1] if lines else tb.strip())[:600]
        print(tb, file=sys.stderr)
        return {"error": line}


def _errors(record: dict) -> list:
    """Every "error" recorded anywhere in the record."""
    found = []
    for k, v in record.items():
        if k == "error":
            found.append(v)
        elif isinstance(v, dict):
            found.extend(_errors(v))
    return found


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--scenario",
        choices=["all", "precompute", "sweep", "large"],
        default="all",
        help="'precompute' = north-star 800px throughput; 'sweep' = dense "
        "25pt x 4-codec 512px flagship; 'large' = 2048px CLIC-class + "
        "mixed-size masked buckets; 'all' = every scenario (default)",
    )
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import card_line
    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench needs a GPU; JAX's first device is {dev.platform!r}")
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card_line(),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }

    if args.scenario == "large":
        large = _guarded(run_large_scenario, jax, jnp)
        record = {
            "metric": "pairs_per_sec_2048px_allmetric",
            "value": large.get("pairs_per_sec_2048px_allmetric"),
            "unit": "pairs/s/card",
            "vs_baseline": None,
            **{
                k: v
                for k, v in large.items()
                if k != "pairs_per_sec_2048px_allmetric"
            },
        }
    elif args.scenario == "sweep":
        sweep = _guarded(run_sweep_scenario, jax, jnp)
        record = {
            "metric": "allmetric_sweep_pairs_per_sec_512px",
            "value": sweep.get("allmetric_pairs_per_sec"),
            "unit": "pairs/s/card",
            "vs_baseline": None,
            **{k: v for k, v in sweep.items() if k != "allmetric_pairs_per_sec"},
        }
    else:
        pre = _guarded(run_precompute_scenario, jax, jnp)
        record = {
            "metric": "ssimulacra2_images_per_sec_800px",
            "value": pre.get("value"),
            "unit": "img/s/card",
            "vs_baseline": pre.get("vs_baseline"),
            "spread": pre.get("spread"),
        }
        if "error" in pre:
            record["error"] = pre["error"]
        if args.scenario == "all":
            record["sweep"] = _guarded(run_sweep_scenario, jax, jnp)
            record["large"] = _guarded(run_large_scenario, jax, jnp)

    record["device"] = device
    print(json.dumps(record))
    if _errors(record):
        sys.exit(1)


if __name__ == "__main__":
    main()
