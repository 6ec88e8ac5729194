"""Time the scoring stages on a GPU.

Prints one line per measurement (medians of device-synchronised repeats)
and writes them all as JSON to ``chiprun_out/gpu_stage_times.json``:

- the device memory of the all-metric chunk program per candidate pixel
  (the basis of the ladder runner's scoring budget);
- the plain XLA time of each stage that used to be a hand-written kernel:
  SSIMULACRA2 per-scale features of a candidate batch, Butteraugli's opsin +
  band separation (``_psycho_batch``), its batched renormalised blurs, the
  candidate-side mask term and the Malta sweeps — the times a later
  hand-written kernel must beat.

Shapes are the scoring cells' own: 512px x 25 candidates and 2048px x 5.

    python tools/gpu_stage_times.py [--reps N] [--sizes 512:25,2048:5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import card_line, distortions, photo  # noqa: E402

RESULTS: list = []


def record(name: str, **fields) -> None:
    RESULTS.append({"name": name, **fields})
    print(name + ": " + ", ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, *args, reps: int) -> float:
    """Median wall milliseconds of ``fn(*args)`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def chunk_inputs(side: int, n: int):
    import jax.numpy as jnp

    ref = photo(side, side, 11)
    cands = distortions(ref, 12, n)
    return jnp.asarray(ref), jnp.asarray(np.ascontiguousarray(np.moveaxis(cands, -1, 1)))


def chunk_fn(side: int, n: int, metrics=(True, True, True, True)):
    """(jitted precompute, jitted planar chunk scorer) for the cell shape."""
    from codec_eval_tpu.engine.scoring import _build_chunk_scorer, _build_precompute

    d, s2, ba, ps = metrics
    pre = _build_precompute(side, side, d, s2, ba, False)
    return pre, _build_chunk_scorer(side, side, n, d, s2, ba, ps, planar=True)


def stage_times(side: int, n: int, reps: int) -> None:
    import importlib

    import jax
    import jax.numpy as jnp

    from codec_eval_tpu.kernels.color import srgb_u8_to_linear

    # The kernels package re-exports functions that shadow these modules.
    ba = importlib.import_module("codec_eval_tpu.kernels.butteraugli")
    s2 = importlib.import_module("codec_eval_tpu.kernels.ssimulacra2")

    ref_u8, cands = chunk_inputs(side, n)
    lin = jax.jit(jax.vmap(srgb_u8_to_linear))(cands)
    jax.block_until_ready(lin)
    ref_pre = jax.jit(s2.precompute_reference)(ref_u8)
    tag = f"{side}px/{n}"

    ref_planar = jnp.moveaxis(ref_u8, -1, 0)
    ssim2 = jax.jit(
        lambda r, c, l: s2.ssimulacra2_batch_pre(r, ref_planar, c, lin_planar=l)
    )
    record(f"xla ssimulacra2 batch features {tag}",
           ms=time_ms(ssim2, ref_pre, cands, lin, reps=reps))

    psycho = jax.jit(ba._psycho_batch)
    scaled = lin * 80.0
    record(f"xla butteraugli opsin+bands {tag}", ms=time_ms(psycho, scaled, reps=reps))

    planes = jax.random.normal(jax.random.key(0), (n, 3, side, side), jnp.float32)
    for sigma, label in ((ba.SIGMA_LF, "lf 7.16"), (ba.SIGMA_MASK, "mask 2.7")):
        blur = jax.jit(lambda p, s=sigma: ba._blur(p, s))
        record(f"xla butteraugli batched blur {label} (3 planes) {tag}",
               ms=time_ms(blur, planes, reps=reps))

    pi1 = psycho(scaled)
    b0 = planes[0, 0]
    mask_ac = jax.jit(ba._mask_diff_ac_batch)
    record(f"xla butteraugli mask diff_ac {tag}", ms=time_ms(mask_ac, pi1, b0, reps=reps))

    for s in (side, (side + 1) // 2):  # full and half resolution
        stack = jax.random.normal(jax.random.key(1), (n, 6, s, s), jnp.float32)
        malta = jax.jit(ba._malta_ac_batch)
        record(f"xla butteraugli malta sweeps {s}px/{n}", ms=time_ms(malta, stack, reps=reps))


def memory(side: int, n: int, reps: int) -> None:
    """Device memory the all-metric chunk program needs, per candidate
    pixel: the basis of the ladder runner's scoring budget."""
    import jax
    import jax.numpy as jnp

    del reps
    pre, fn = chunk_fn(side, n)
    ref = jax.ShapeDtypeStruct((side, side, 3), jnp.uint8)
    compiled = fn.lower(
        jax.eval_shape(pre, ref),
        jax.ShapeDtypeStruct((n, 3, side, side), jnp.uint8),
    ).compile()
    m = compiled.memory_analysis()
    temp = int(m.temp_size_in_bytes)
    record(f"memory all-metric chunk {side}px/{n}",
           temp_bytes=temp, argument_bytes=int(m.argument_size_in_bytes),
           output_bytes=int(m.output_size_in_bytes),
           temp_bytes_per_candidate_px=round(temp / (n * side * side), 1))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--sizes", default="512:25,2048:5")
    parser.add_argument(
        "--only", default="memory,stages",
        help="comma list of parts to run",
    )
    args = parser.parse_args()

    import jax

    from codec_eval_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, JAX's first device is {dev.platform!r}")
    record("device", card=card_line(), kind=dev.device_kind, jax=jax.__version__)
    parts = set(args.only.split(","))
    for cell in args.sizes.split(","):
        side, n = (int(v) for v in cell.split(":"))
        for part, fn in (("memory", memory), ("stages", stage_times)):
            if part in parts:
                try:
                    fn(side, n, args.reps)
                except Exception as e:  # noqa: BLE001 - report and go on
                    record(f"{part} {side}px/{n}", error=f"{type(e).__name__}: {str(e)[:400]}")
    out = REPO / "chiprun_out" / "gpu_stage_times.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()
