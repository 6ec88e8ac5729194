"""Repository-wide checks: no accelerator-specific routing, one compile-cache
location."""

import re
import subprocess
from pathlib import Path

import jax
import pytest

from codec_eval_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def _python_files():
    out = subprocess.run(
        ["git", "ls-files", "--cached", "--others", "--exclude-standard", "*.py"],
        cwd=REPO, capture_output=True, text=True,
    )
    files = [REPO / f for f in out.stdout.split()] if out.returncode == 0 else []
    return files or sorted(REPO.rglob("*.py"))


# Each pattern is assembled from pieces so that this file does not match
# it (and a repository grep for the literal finds nothing here either).
@pytest.mark.parametrize(
    "pattern",
    [
        "pallas" + r"(\s+import\s+|\.)" + "tpu" + "|pl" + "tpu",
        "default_" + r"backend\(\)\s*(==|!=|in\b|not in\b)",
        "/tmp/" + "jax_cache",
    ],
    ids=["pallas-tpu-import", "backend-test", "tmp-cache-dir"],
)
def test_no_file_matches(pattern):
    rx = re.compile(pattern)
    hits = [
        f"{f.relative_to(REPO)}:{i}"
        for f in _python_files()
        if f.exists()
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if rx.search(line)
    ]
    assert not hits, hits


def test_compile_cache_uses_the_variable_when_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_repo_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
