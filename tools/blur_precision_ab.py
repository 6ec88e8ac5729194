"""Butteraugli's blur matmuls at HIGH (TF32 on a GPU) against HIGHEST.

Scores the smoke test's 512px x 25 parity batch with Butteraugli alone,
once with every blur contraction at ``Precision.HIGHEST`` (the package's
setting) and once at ``Precision.HIGH``, and compares both with the CPU
float32 reference, computed in a child process that never opens the card.
Prints, for each precision, the largest relative error against
``chip_smoke.py``'s Butteraugli tier, the tier failures, and the median
device time of the program; writes them to
``chiprun_out/blur_precision_ab.json``.

    python tools/blur_precision_ab.py [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def batch():
    """The parity phase's 512px reference and 25 candidates."""
    _, ref, cands = chip_smoke.parity_inputs()[0]
    return ref, cands


def lowered(precision: str, ref, cands):
    """Butteraugli-only program with the blur contractions at ``precision``,
    traced now (the module constant is read at trace time)."""
    import importlib

    import jax

    ba = importlib.import_module("codec_eval_tpu.kernels.butteraugli")
    saved = ba._HIGHEST
    ba._HIGHEST = getattr(jax.lax.Precision, precision)
    try:
        fn = jax.jit(
            lambda r, c: ba.butteraugli_batch(ba.precompute_butteraugli_reference(r), c)
        )
        return fn.lower(ref, cands)
    finally:
        ba._HIGHEST = saved


def cpu_main() -> None:
    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    assert jax.devices()[0].platform == "cpu", jax.devices()
    ref, cands = batch()
    print(json.dumps(np.asarray(lowered("HIGHEST", ref, cands).compile()(ref, cands)).tolist()))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.cpu:
        cpu_main()
        return

    import jax
    import jax.numpy as jnp

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, JAX's first device is {dev.platform!r}")
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES=""),
    )
    try:
        ref, cands = (jnp.asarray(a) for a in batch())
        precisions = ("HIGHEST", "HIGH")
        lows = [lowered(p, ref, cands) for p in precisions]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(lows)) as pool:
            programs = list(pool.map(lambda low: low.compile(), lows))
        print(f"compiled both in {time.perf_counter() - t0:.1f} s", flush=True)
        scores, times = {}, {}
        for p, prog in zip(precisions, programs):
            scores[p] = np.asarray(prog(ref, cands)).tolist()
            ms = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(prog(ref, cands))
                ms.append((time.perf_counter() - t0) * 1e3)
            times[p] = statistics.median(ms)
        out, err = child.communicate(timeout=900)
        if child.returncode != 0:
            sys.exit(f"CPU reference failed:\n{err[-3000:]}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    cpu = json.loads(out.strip().splitlines()[-1])
    result = {"card": chip_smoke.card_line(), "kind": dev.device_kind,
              "tier": chip_smoke.TIERS["butteraugli"]}
    for p in precisions:
        worst = chip_smoke.max_rel({"x": {"butteraugli": scores[p]}},
                                   {"x": {"butteraugli": cpu}})
        result[p] = {"max_rel_vs_cpu": worst["butteraugli"],
                     "tier_failures": chip_smoke.tier_failures(worst),
                     "median_ms": times[p]}
        print(f"{p}: max rel vs CPU {worst['butteraugli']:.3e}, "
              f"tier failures {result[p]['tier_failures']}, "
              f"median {times[p]:.2f} ms (512px x 25, Butteraugli only)", flush=True)
    dest = REPO / "chiprun_out" / "blur_precision_ab.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
