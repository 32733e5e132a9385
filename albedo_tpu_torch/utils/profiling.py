"""Accumulating named wall-clock sections.

Port of ``albedo_tpu/utils/profiling.py Timer`` (the part the ranker's stage
breakdown uses). A section that times device work passes ``sync`` (a torch
device): the section then waits for that device before it stops the clock,
so its time includes the queued kernels.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterator

import torch


def _sync(device: Any) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Named sections: ``totals[name]`` seconds over ``counts[name]`` calls."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str, sync: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, printer: Callable[[str], None] = print) -> dict[str, float]:
        for name in sorted(self.totals, key=self.totals.get, reverse=True):  # type: ignore[arg-type]
            printer(f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} call(s)")
        return dict(self.totals)
