"""Profiling and tracing utilities.

The reference's observability is ad-hoc Instant timers around encode/decode
(SURVEY.md §5); this module keeps those per-stage timers (they feed the
``encode_ms``/``decode_ms`` report fields) and adds the device layer the
reference lacks: ``jax.profiler`` trace capture around scoring dispatches,
and a lightweight structured event log.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage."""

    totals_ms: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000
            self.totals_ms[name] = self.totals_ms.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_ms": round(self.totals_ms[name], 2),
                "count": self.counts[name],
                "mean_ms": round(self.totals_ms[name] / self.counts[name], 3),
            }
            for name in self.totals_ms
        }

    def print_summary(self, out=sys.stderr) -> None:
        for name, s in sorted(self.summary().items()):
            print(
                f"  {name:<24} {s['total_ms']:>10.1f} ms  "
                f"({s['count']} x {s['mean_ms']:.2f} ms)",
                file=out,
            )


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace (view in TensorBoard / Perfetto).

    No-op when log_dir is None, so call sites can be left in place.
    """
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class EventLog:
    """Append-only structured JSONL event log (the durable-observability
    layer the reference's bare eprintln lacks)."""

    def __init__(self, path: Optional[Path] = None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        self._fh = open(self.path, "a") if self.path else None

    def event(self, kind: str, **fields) -> None:
        record = {"t": time.time(), "kind": kind, **fields}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            print(f"[{kind}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
                  file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
