"""chip_smoke.py's pure parts, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_result_line_is_the_contract_object():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


@pytest.mark.parametrize(
    "worst, bad",
    [
        ({"psnr": 0.0, "dssim": 9e-5, "ssimulacra2": 1e-5, "butteraugli": 1e-5}, {}),
        ({"psnr": 2e-5, "dssim": 0.0, "ssimulacra2": 0.0, "butteraugli": 0.0},
         {"psnr": 2e-5}),
        ({"psnr": 0.0, "dssim": 0.0, "ssimulacra2": 0.0, "butteraugli": 2e-3},
         {"butteraugli": 2e-3}),
        ({"psnr": 0.0, "dssim": 0.0, "ssimulacra2": 0.0, "butteraugli": 1e-4},
         {"butteraugli": 1e-4}),
        ({"psnr": 0.0, "dssim": 2e-4, "ssimulacra2": 3e-5, "butteraugli": 0.0},
         {"dssim": 2e-4, "ssimulacra2": 3e-5}),
        ({"psnr": float("nan"), "dssim": 0.0, "ssimulacra2": 0.0, "butteraugli": 0.0},
         {"psnr": float("nan")}),
    ],
    ids=["within", "psnr-over", "butteraugli-over", "butteraugli-tf32-size",
         "dssim-ssimulacra2-over", "nan-fails"],
)
def test_tier_failures(worst, bad):
    got = chip_smoke.tier_failures(worst)
    assert set(got) == set(bad)


def test_max_rel_takes_the_worst_case_per_metric():
    want = {"a": {"psnr": [10.0, 20.0]}, "b": {"psnr": [40.0]}}
    got = {"a": {"psnr": [10.0, 20.002]}, "b": {"psnr": [40.0]}}
    assert chip_smoke.max_rel(got, want)["psnr"] == pytest.approx(1e-4)


def test_distortions_are_seeded_and_distinct():
    ref = chip_smoke.photo(32, 40, 1)
    a = chip_smoke.distortions(ref, 2, 5)
    b = chip_smoke.distortions(ref, 2, 5)
    assert a.shape == (5, 32, 40, 3) and a.dtype == ref.dtype
    assert (a == b).all()
    assert len({d.tobytes() for d in a}) == 5


def test_four_card_path_on_virtual_cpu_devices(capsys):
    """The four-card path, threads and comparisons included, at 64px on
    four of the suite's virtual CPU devices."""
    chip_smoke.run_four_cards(side=64)
    out = capsys.readouterr().out
    for line in ("mesh 4x1 vs 1x1", "mesh 2x2 spatial vs 1x1",
                 "masked buckets 4x1 vs 1x1", "ladder 4 cards vs 1x1",
                 "ladder 4 cards: byte sizes identical to 1x1"):
        assert line in out, out


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_a_cpu_device():
    out = _run(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_refuses_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
