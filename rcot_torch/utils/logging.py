"""JSONL metrics log, step timing and a profiler window.

Counterpart of rcot_tpu/utils/logging.py:21-108, for one process: every
event is one JSON line (non-finite floats written as null, so the file
stays strict JSON), appended to the run's log file and echoed to stdout.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL logger; one record per event, host scalars only."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, event: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"event": event, "time": time.time()}
        for k, v in fields.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float) and not math.isfinite(v):
                v = None
            rec[k] = v
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
        print(line, flush=True)


class StepTimer:
    """Wall-clock throughput meter (items/s, s/step) that skips `warmup`
    steps."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.items = 0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
            self.items += n_items
        return dt

    @property
    def steps_timed(self) -> int:
        return max(0, self.count - self.warmup)

    def mean_step_time(self) -> float:
        return self.total / self.steps_timed if self.steps_timed else float("nan")

    def items_per_sec(self) -> Optional[float]:
        return self.items / self.total if self.total else None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler (CPU and, where there is one, CUDA activity) around a
    region, its Chrome trace written into log_dir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
