"""Wall-clock timing (port of ``heatray_tpu.utils.timing``): the analog of
``Source/Utility/Timer.h`` and of the pass and total counters
``PassGenerator`` feeds the UI (``HeatrayRenderer.cpp:957-962``).

CUDA launches are asynchronous, so a wall clock around a call measures its
enqueue time.  ``slope_time`` times chains of steps, each ended by a
synchronizing fetch, and returns the slope: the time per step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


class Timer:
    """Start/stop wall timer (``Timer.h:15-86`` semantics)."""

    def __init__(self, start_now: bool = False):
        self._start = None
        self.dt = 0.0
        if start_now:
            self.start()

    def start(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self.dt = time.perf_counter() - self._start
            self._start = None
        return self.dt

    def restart(self) -> None:
        self._start = time.perf_counter()


@dataclass
class RenderTimers:
    """Per-pass timings and the total render time (the UI's counters)."""

    pass_times: List[float] = field(default_factory=list)
    total: Timer = field(default_factory=lambda: Timer(start_now=True))

    def record_pass(self, seconds: float) -> None:
        self.pass_times.append(seconds)

    @property
    def passes_completed(self) -> int:
        return len(self.pass_times)

    @property
    def mean_pass_time(self) -> float:
        return sum(self.pass_times) / max(len(self.pass_times), 1)

    def summary(self) -> Dict[str, float]:
        return {
            "passes": self.passes_completed,
            "mean_pass_s": self.mean_pass_time,
            "total_s": self.total.stop(),
        }


def fetch_tensor(value) -> None:
    """Wait for ``value`` (a tensor): ``torch.cuda.synchronize()`` on the
    card, nothing on the CPU, where every op has finished on return."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def slope_time(step: Callable[[int], object], fetch: Callable[[object], None] = fetch_tensor,
               n1: int = 2, n2: int = 10) -> float:
    """Fetch-slope timing: seconds per step.  ``step(n)`` runs an n-deep
    chained computation and returns its final value; ``fetch(value)`` must
    wait for it (``fetch_tensor``)."""

    def run(n: int) -> float:
        t0 = time.perf_counter()
        fetch(step(n))
        return time.perf_counter() - t0

    run(1)
    t1 = run(n1)
    t2 = run(n2)
    return max((t2 - t1) / (n2 - n1), 0.0)
