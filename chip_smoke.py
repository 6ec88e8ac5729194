"""Smoke test of the scoring path on an NVIDIA GPU.

Drives the main entry points once at real sizes and checks what comes out:

- the session path (``EvalSession.evaluate_corpus``) over three 512px
  photos x 25 tpujpeg qualities with every metric, reports written and read
  back;
- the device-resident ladder (``evaluate_tpujpeg_sweep``) with exact and
  device-side byte sizes;
- one CLIC-class 2048px reference x 5 candidates through ``BatchScorer``;
- parity of all four metrics against the same XLA formulation run in a
  CPU-only child process (float32), at 512px and 2048px;
- the 24-pair libjxl Butteraugli oracle fixture through the batch path.

With ``--four-cards`` it runs only the multi-card path at 512px (4x1 and 2x2
meshes, masked mixed-size buckets, the 4-card ladder), each compared with
the same inputs on a 1x1 mesh of device 0.

Run from the repository root:

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # four cards

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
every other line comes before it.  Any failed phase exits non-zero without
that line, and so does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: Largest relative error of the card's scores against the CPU float32
#: reference.  Summation order and exp/log/cbrt ulps differ between the two
#: backends.  Measured on an H100 (PERF.md): psnr 1.0e-7, dssim 9.3e-5,
#: ssimulacra2 1.5e-6, butteraugli 1.6e-6.  SSIMULACRA2 and Butteraugli sit
#: at about six times their readings (PERF.md has what a TF32 matmul does to
#: Butteraugli); DSSIM is 1/ssim - 1 with ssim near 1, so its relative
#: error is an absolute ssim error of ~1e-8 blown up.
TIERS = {"psnr": 1e-5, "dssim": 1e-4, "ssimulacra2": 1e-5, "butteraugli": 1e-5}

#: Relative-error gates of the oracle fixture (tests/test_butteraugli_oracle.py).
ORACLE_MEDIAN_MAX = 0.005
ORACLE_P90_MAX = 0.02
ORACLE_WORST_MAX = 0.08

SESSION_QUALITIES = [float(round(10 + i * 88 / 24)) for i in range(25)]
METRICS = ("dssim", "ssimulacra2", "butteraugli", "psnr")

#: Image sides of the one-card phases: (session and ladder, CLIC chunk).
#: The parity phase scores 25 candidates at the first and the CLIC chunk's
#: 5 at the second, so it shares their compiled programs.
SIDES = (512, 2048)

#: Image side of the four-card path: the session's.
FOUR_CARD_SIDE = SIDES[0]


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded synthetic photo: smooth structure plus sensor-like noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (
        118 + 68 * np.sin(x / 13.0) + 52 * np.cos(y / 9.0)
        + 24 * np.sin((x + y) / 31.0)
    )
    img = np.stack([base, base * 0.88 + 12, base * 0.74 + 26], -1)
    return np.clip(img + rng.normal(0, 7, img.shape), 0, 255).astype(np.uint8)


def distortions(ref: np.ndarray, seed: int, n: int) -> np.ndarray:
    """``n`` numpy distortions of ``ref``: noise, posterize, 2x2 box blur,
    gain + offset, then stronger noise (cycled)."""
    rng = np.random.default_rng(seed)
    r = ref.astype(np.int16)
    box = ref.astype(np.float32)
    box = 0.25 * (box + np.roll(box, 1, 0) + np.roll(box, 1, 1)
                  + np.roll(np.roll(box, 1, 0), 1, 1))
    kinds = [
        r + rng.integers(-9, 10, ref.shape),
        (r // 12) * 12 + 6,
        np.rint(box),
        np.rint(r * 0.93 + 9),
        r + rng.integers(-25, 26, ref.shape),
    ]
    out = [np.clip(kinds[i % len(kinds)], 0, 255).astype(np.uint8) for i in range(n)]
    return np.stack(out)


def parity_inputs(sides=None):
    """Fixed inputs of the parity phase: 25 candidates at the small side
    (the session's batch) and the CLIC chunk's 5 at the large one."""
    small, large = sides or SIDES
    ref_s = photo(small, small, 31)
    ref_l = photo(large, large, 900)
    return [
        (f"{small}px/25", ref_s, distortions(ref_s, 32, 25)),
        (f"{large}px/5", ref_l, distortions(ref_l, 901, 5)),
    ]


def score_parity_inputs(sides=None) -> dict:
    """{case: {metric: [scores]}} through ``BatchScorer`` on the default device."""
    from codec_eval_tpu.engine.scoring import BatchScorer
    from codec_eval_tpu.metrics import MetricConfig

    scorer = BatchScorer(MetricConfig.all())
    out = {}
    for name, ref, cands in parity_inputs(sides):
        res = scorer.score_batch(ref, cands)
        out[name] = {m: [getattr(r, m) for r in res] for m in METRICS}
    return out


def max_rel(got: dict, want: dict) -> dict:
    """Largest relative error per metric over every case."""
    worst = {}
    for case, metrics in want.items():
        for m, ref_vals in metrics.items():
            a = np.asarray(got[case][m], np.float64)
            b = np.asarray(ref_vals, np.float64)
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))
            worst[m] = max(worst.get(m, 0.0), rel)
    return worst


def tier_failures(worst: dict) -> dict:
    """Metrics whose largest relative error exceeds its tier."""
    return {m: v for m, v in worst.items() if not v <= TIERS[m]}


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of standard output on success."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return " | ".join(out.stdout.strip().splitlines())


def start_cpu_reference(sides=None) -> subprocess.Popen:
    """The CPU float32 reference, in a child that never opens the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--cpu-reference", ",".join(map(str, sides or SIDES))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT),
    )


def cpu_reference_main(sides) -> None:
    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    assert jax.devices()[0].platform == "cpu", jax.devices()
    print(json.dumps(score_parity_inputs(sides)))


# ---------------------------------------------------------------------------
# One-card phases.
# ---------------------------------------------------------------------------


def phase_native() -> None:
    out = subprocess.run(
        ["make", "-C", str(ROOT / "native")], capture_output=True, text=True,
        timeout=300,
    )
    if out.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{out.stderr[-2000:]}")
    from codec_eval_tpu.utils import native

    if not native.jpeg_entropy_available():
        raise RuntimeError("native JPEG entropy coder missing after make")
    log("native: libcodec_eval_native.so built")


def phase_session() -> dict:
    import codec_eval_tpu as ce
    from codec_eval_tpu.codecs.tpujpeg import TpuJpegCodec

    side = SIDES[0]
    items = [
        (f"photo{i}", ce.ImageData.rgb8(photo(side, side, 100 + i)))
        for i in range(3)
    ]
    times = {}
    with tempfile.TemporaryDirectory() as td:
        cfg = (
            ce.EvalConfig.builder()
            .report_dir(td)
            .metrics(ce.MetricConfig.all())
            .quality_levels(SESSION_QUALITIES)
            .build()
        )
        session = ce.EvalSession(cfg)
        session.add_codec_impl(TpuJpegCodec())
        t0 = time.perf_counter()
        first = session.evaluate_corpus(items[:1], name="first")
        times["first_score_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = session.evaluate_corpus(items, name="smoke")
        times["warm_corpus_s"] = time.perf_counter() - t0
        session.write_corpus_report(report)
        data = json.loads((Path(td) / "smoke.json").read_text())
        csv_lines = (Path(td) / "smoke.csv").read_text().splitlines()
    assert first.images, "first image was not scored"
    assert len(data["images"]) == 3, data["images"]
    assert len(csv_lines) == 1 + 3 * len(SESSION_QUALITIES), len(csv_lines)
    for img in data["images"]:
        rows = sorted(img["results"], key=lambda r: r["quality"])
        assert len(rows) == len(SESSION_QUALITIES)
        for r in rows:
            vals = [r["metrics"][m] for m in METRICS]
            assert all(v is not None and np.isfinite(v) for v in vals), r
            assert r["file_size"] > 0, r
        s2 = np.array([r["metrics"]["ssimulacra2"] for r in rows])
        assert s2[-1] - s2[0] > 5.0, s2
        assert np.all(np.diff(s2) > -1.0), s2
        log(f"session {img['name']}: ssimulacra2 q10 {s2[0]:.2f} -> q98 {s2[-1]:.2f}")
    return times


def phase_ladder() -> None:
    from codec_eval_tpu.engine.tpu_sweep import evaluate_tpujpeg_sweep

    img = photo(SIDES[0], SIDES[0], 7)
    exact = evaluate_tpujpeg_sweep(img, SESSION_QUALITIES, with_sizes=True)
    dev = evaluate_tpujpeg_sweep(img, SESSION_QUALITIES, with_sizes="device")
    se = np.array([p.file_size for p in exact], np.int64)
    sd = np.array([p.file_size for p in dev], np.int64)
    bound = np.maximum(6, 0.004 * se)
    assert (np.abs(sd - se) <= bound).all(), (se, sd)
    for pe, pd in zip(exact, dev):
        for m in METRICS:
            assert np.isfinite(pe.metrics[m]) and pe.metrics[m] == pd.metrics[m], (
                pe.quality, m, pe.metrics[m], pd.metrics[m],
            )
    log(
        f"ladder {SIDES[0]}px/25: device sizes within bound, worst "
        f"{int(np.max(np.abs(sd - se)))} B of {int(se.min())}-{int(se.max())} B"
    )


def check_clic_chunk(scores: dict) -> None:
    """The 2048px chunk's GPU scores: finite, and mild noise (first) above
    strong noise (last)."""
    name = f"{SIDES[1]}px/5"
    for m in METRICS:
        vals = scores[name][m]
        assert len(vals) == 5 and all(
            v is not None and np.isfinite(v) for v in vals
        ), (m, vals)
    s2 = scores[name]["ssimulacra2"]
    assert s2[0] > s2[4], s2
    log(f"clic chunk {name}: ssimulacra2 " + ", ".join(f"{v:.2f}" for v in s2))


def phase_oracle() -> dict:
    import jax
    import jax.numpy as jnp

    from codec_eval_tpu.kernels.butteraugli import (
        butteraugli_batch,
        precompute_butteraugli_reference,
    )

    fixture = np.load(ROOT / "tests" / "goldens" / "butteraugli_oracle.npz")
    bases, ridx, dists, gold = (
        fixture["bases"], fixture["ref_index"], fixture["dists"], fixture["gold"]
    )
    ours = np.empty(len(ridx))
    score = jax.jit(
        lambda ref, batch: butteraugli_batch(
            precompute_butteraugli_reference(ref), batch
        )
    )
    for b in np.unique(ridx):
        idx = np.nonzero(ridx == b)[0]
        ours[idx] = np.asarray(score(jnp.asarray(bases[b]), jnp.asarray(dists[idx])))
    rel = np.abs(ours - gold) / np.maximum(gold, 1e-9)
    stats = {
        "median": float(np.median(rel)),
        "p90": float(np.quantile(rel, 0.9)),
        "max": float(rel.max()),
    }
    log(f"oracle (batch path, 24 pairs): {stats}")
    assert stats["median"] <= ORACLE_MEDIAN_MAX, stats
    assert stats["p90"] <= ORACLE_P90_MAX, stats
    assert stats["max"] <= ORACLE_WORST_MAX, stats
    return stats


def phase_compile_times() -> None:
    """Compile seconds of the all-metric chunk scorer (session shape), first
    into the persistent cache and then again from it; informational."""
    import jax
    import jax.numpy as jnp

    from codec_eval_tpu.engine import scoring

    side = SIDES[0]
    cache = Path(jax.config.jax_compilation_cache_dir)

    def entries() -> int:
        return sum(1 for _ in cache.rglob("*")) if cache.is_dir() else 0

    def compile_once() -> float:
        scoring._build_chunk_scorer.cache_clear()
        scoring._build_precompute.cache_clear()
        jax.clear_caches()
        pre = scoring._build_precompute(side, side, True, True, True, False)
        ref = jax.ShapeDtypeStruct((side, side, 3), jnp.uint8)
        fn = scoring._build_chunk_scorer(
            side, side, 25, True, True, True, True, planar=True
        )
        t0 = time.perf_counter()
        pre.lower(ref).compile()
        fn.lower(
            jax.eval_shape(pre, ref),
            jax.ShapeDtypeStruct((25, 3, side, side), jnp.uint8),
        ).compile()
        return time.perf_counter() - t0

    before = entries()
    first = compile_once()
    kind = "cold" if entries() > before else "already cached"
    second = compile_once()
    # Leave nothing compiled in memory: the session's first score then
    # starts from the persistent cache, as a new process would.
    scoring._build_chunk_scorer.cache_clear()
    scoring._build_precompute.cache_clear()
    jax.clear_caches()
    log(
        f"compile {side}px/25 all-metric: {kind} {first:.1f} s, "
        f"from persistent cache {second:.1f} s"
    )


def run_one_card() -> None:
    child = start_cpu_reference()
    try:
        phase_native()
        phase_compile_times()
        t = phase_session()
        log(
            "first-score latency (1 image x 25 qualities, warm persistent cache): "
            f"{t['first_score_s']:.2f} s; "
            f"warm 3-image corpus {t['warm_corpus_s']:.2f} s"
        )
        phase_ladder()
        gpu = score_parity_inputs()
        check_clic_chunk(gpu)
        phase_oracle()
        log("waiting for the CPU reference")
        out, err = child.communicate(timeout=900)
        if child.returncode != 0:
            raise RuntimeError(f"CPU reference failed:\n{err[-3000:]}")
        cpu = json.loads(out.strip().splitlines()[-1])
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    worst = max_rel(gpu, cpu)
    for m in METRICS:
        log(f"parity {m}: max rel {worst[m]:.3e} (tier {TIERS[m]:.0e})")
    bad = tier_failures(worst)
    if bad:
        raise AssertionError(f"GPU vs CPU float32 beyond tiers: {bad}")


# ---------------------------------------------------------------------------
# Four-card path.
# ---------------------------------------------------------------------------


def _compare(name: str, got: dict, want: dict) -> None:
    worst = max_rel({"x": got}, {"x": want})
    log(f"{name}: " + ", ".join(f"{m} {v:.2e}" for m, v in sorted(worst.items())))
    bad = tier_failures(worst)
    if bad:
        raise AssertionError(f"{name} beyond tiers: {bad}")


def four_card_cases(side: int = FOUR_CARD_SIDE):
    """[(name, run, compile_only, [(label, (n_batch, n_space))])]: the
    sharded paths at ``side`` px, each run on the listed meshes and on a 1x1
    mesh.  ``run(mesh)`` returns {metric: scores} (and "sizes" for the
    ladder); ``compile_only(mesh)`` compiles the mesh's programs without
    running them, and is None where those programs hold no cross-card
    collective."""
    from codec_eval_tpu.parallel.corpus_runner import (
        score_pairs_sharded,
        stage_pairs_sharded,
    )
    from codec_eval_tpu.parallel.ladder_runner import sweep_corpus_ladders
    from codec_eval_tpu.parallel.mesh import shard_batch, sharded_score_fn

    # Dense SPMD step: 8 pairs, 4x1 and 2x2 (rows sharded).
    refs = np.stack([photo(side, side, 300 + i) for i in range(8)])
    dists = np.stack([distortions(r, 400 + i, 1)[0] for i, r in enumerate(refs)])

    def dense_args(mesh):
        spatial = mesh.devices.shape[1] > 1
        return (
            sharded_score_fn(mesh, spatial=spatial),
            shard_batch(mesh, refs, spatial=spatial),
            shard_batch(mesh, dists, spatial=spatial),
        )

    def dense(mesh):
        step, r, d = dense_args(mesh)
        per_pair, _ = step(r, d)
        return {k: np.asarray(v).tolist() for k, v in per_pair.items()}

    def dense_compile(mesh):
        step, r, d = dense_args(mesh)
        step.lower(r, d).compile()

    # Masked mixed-size buckets: four sizes in one bucket.
    pairs = []
    shapes = ((side * 25 // 32, side), (side, side * 11 // 16), (side, side),
              (side * 5 // 8, side * 7 // 8))
    for i, (h, w) in enumerate(shapes):
        r = photo(h, w, 500 + i)
        pairs.append((r, distortions(r, 600 + i, 1)[0]))

    def masked(mesh):
        res = score_pairs_sharded(pairs, mesh=mesh, masked=True, granularity=side)
        return {m: [row[m] for row in res.per_pair] for m in METRICS}

    def masked_compile(mesh):
        staged = stage_pairs_sharded(pairs, mesh=mesh, masked=True, granularity=side)
        for _, r, d, hw in staged.buckets:
            staged.step.lower(r, d, hw).compile()

    # Ladder: 5 images x the session's 25 qualities, every metric,
    # device-side sizes.  One image per card per step: the 1x1 reference
    # then compiles one pipeline, not the 8 the default unrolls.
    images = [photo(side, side, 700 + i) for i in range(5)]

    def ladder(mesh):
        res = sweep_corpus_ladders(
            images, SESSION_QUALITIES, mesh=mesh, with_sizes="device",
            images_per_chunk=1,
        )
        out = {m: res.scores[m].reshape(-1).tolist() for m in METRICS}
        out["sizes"] = res.sizes.reshape(-1).tolist()
        return out

    return [
        ("mesh", dense, dense_compile, [("4x1", (4, 1)), ("2x2 spatial", (2, 2))]),
        ("masked buckets", masked, masked_compile, [("4x1", (4, 1))]),
        ("ladder", ladder, None, [("4 cards", (4, 1))]),
    ]


def _in_threads(jobs: dict) -> dict:
    """Run {key: fn} concurrently; {key: (result, seconds)}.  Raises the
    first failure without waiting for the other jobs."""
    from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        log(f"{' '.join(key)}: {secs:.1f} s")
        return out, secs

    pool = ThreadPoolExecutor(len(jobs))
    futures = {pool.submit(timed, key, fn): key for key, fn in jobs.items()}
    done, _ = wait(futures, return_when=FIRST_EXCEPTION)
    for fut in done:
        if fut.exception() is not None:
            pool.shutdown(wait=False, cancel_futures=True)
            raise RuntimeError(f"{futures[fut]} failed") from fut.exception()
    pool.shutdown()
    return {key: fut.result() for fut, key in futures.items()}


def run_four_cards(side: int = FOUR_CARD_SIDE) -> None:
    """The sharded paths against a 1x1 mesh of device 0.

    Compilation is most of the cost, so the programs compile concurrently:
    the 1x1 references and the ladder (no cross-card collective) run
    outright in threads, while the sharded programs with collectives only
    compile there.  Those then run one at a time, since two programs with
    collectives enqueued from two threads may reach the cards in different
    orders and wait on each other."""
    import jax

    from codec_eval_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {len(devs)}")
    one = make_mesh(n_batch=1, n_space=1, devices=devs[:1])
    cases = four_card_cases(side)
    concurrent, serial = {}, {}
    for name, run, compile_only, meshes in cases:
        concurrent[(name, "1x1")] = lambda run=run: run(one)
        for label, shape in meshes:
            job = lambda f=run, s=shape: f(make_mesh(*s))
            if compile_only is None:
                concurrent[(name, label)] = job
            else:
                concurrent[(name, label, "compile")] = (
                    lambda c=compile_only, s=shape: c(make_mesh(*s))
                )
                serial[(name, label)] = job
    results = _in_threads(concurrent)
    for key, job in serial.items():
        t0 = time.perf_counter()
        results[key] = (job(), time.perf_counter() - t0)
        log(f"{' '.join(key)}: {results[key][1]:.1f} s")
    for name, _, _, meshes in cases:
        base = dict(results[(name, "1x1")][0])
        sizes = base.pop("sizes", None)
        for label, _ in meshes:
            got = dict(results[(name, label)][0])
            got_sizes = got.pop("sizes", None)
            _compare(f"{name} {label} vs 1x1", got, base)
            if sizes is not None:
                if got_sizes != sizes:
                    raise AssertionError(f"{name} sizes differ: {got_sizes} vs {sizes}")
                log(f"{name} {label}: byte sizes identical to 1x1")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card path and its 1x1 comparison",
    )
    parser.add_argument("--cpu-reference", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.cpu_reference:
        cpu_reference_main(tuple(int(v) for v in args.cpu_reference.split(",")))
        return

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform!r}")
        sys.exit(1)
    t0 = time.perf_counter()
    try:
        run_four_cards() if args.four_cards else run_one_card()
    except Exception:
        # Exit at once: compile threads still running must not hold it up.
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)
    log(f"total {time.perf_counter() - t0:.1f} s after the device check")
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())), flush=True)


if __name__ == "__main__":
    main()
