"""2-process jax.distributed integration test (VERDICT round-1 item 5).

Launches two REAL processes over a localhost coordinator, each owning 4
virtual CPU devices (8 global), scores a strided-sharded synthetic corpus
through ``host_local_batch_to_global`` + ``sharded_score_fn``, and asserts
both processes produce identical corpus means equal to the single-process
result.  This exercises the actual multi-host code path
(`parallel/multihost.py`) end to end — process-local shard assembly, the
global mesh, and the replicated on-device aggregation — not just the
virtual-mesh approximation used elsewhere in the suite.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_scoring_matches_single_process():
    port = _free_port()
    # Scrub the parent's JAX/XLA settings: the workers pick their own
    # platform and device count before jax.distributed.initialize.
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err}"
        outs.append(out)

    means = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("MEANS ")]
        assert lines, f"no MEANS line in worker output: {out!r}"
        means.append(lines[0])
    # Replicated aggregates must be bit-identical across processes.
    assert means[0] == means[1]

    # And equal to the single-process result on the same corpus (approximate:
    # the 2-process program compiles against a different device assignment,
    # so reduction order differs at float32 round-off level).
    import jax

    from codec_eval_tpu.parallel.mesh import make_mesh, sharded_score_fn
    from tests.multihost_worker import synthetic_corpus

    refs, dists = synthetic_corpus()
    mesh = make_mesh(n_batch=8, n_space=1, devices=jax.devices()[:8])
    _, aggregates = sharded_score_fn(mesh, butteraugli=False)(refs, dists)
    got = {
        kv.split("=")[0]: float(kv.split("=")[1])
        for kv in means[0].removeprefix("MEANS ").split()
    }
    assert set(got) == set(aggregates)
    for k, v in aggregates.items():
        assert got[k] == pytest.approx(float(v), rel=1e-5), k


@pytest.mark.slow
def test_two_process_distributed_ladder_matches_single_process():
    """2-process x 4-device tpujpeg ladder over the multihost path
    (``sweep_corpus_ladders(multihost=True)``, VERDICT r2 #5): per-image
    scores and device-side byte sizes must be identical across processes
    and match the single-process sweep."""
    from codec_eval_tpu.codecs.tpujpeg import is_available as tpujpeg_available

    if not tpujpeg_available():
        pytest.skip("native tpujpeg entropy coder unavailable")

    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port), "ladder"],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err}"
        outs.append(out)

    ladders = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("LADDER ")]
        assert lines, f"no LADDER line in worker output: {out!r}"
        ladders.append(lines[0])
    assert ladders[0] == ladders[1]

    # Single-process reference on the same corpus (shared-memory 8-device
    # mesh; float32 round-off tolerance for the different device program).
    import re as _re

    import jax

    from codec_eval_tpu.parallel.ladder_runner import sweep_corpus_ladders
    from codec_eval_tpu.parallel.mesh import make_mesh
    from tests.multihost_worker import _ladder_corpus

    mesh = make_mesh(n_batch=8, n_space=1, devices=jax.devices()[:8])
    res = sweep_corpus_ladders(
        _ladder_corpus(),
        [50.0, 85.0],
        mesh=mesh,
        metrics=("ssimulacra2", "psnr"),
        with_sizes="device",
    )
    m = _re.match(r"LADDER s2=\[(.*)\] sizes=\[(.*)\]", ladders[0])
    got_s2 = np.array([float(v) for v in m.group(1).split()])
    got_sizes = np.array([int(v) for v in m.group(2).split()])
    np.testing.assert_allclose(
        got_s2, res.scores["ssimulacra2"].reshape(-1), rtol=1e-4
    )
    np.testing.assert_array_equal(got_sizes, res.sizes.reshape(-1))
