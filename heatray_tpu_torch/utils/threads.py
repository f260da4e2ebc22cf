"""CPU threads of torch's intra-op pool."""

from __future__ import annotations

import os

import torch


def share_cores(workers: int) -> int:
    """Give this process an equal share of the host's cores when ``workers``
    processes run torch side by side (a test run with several workers):
    each would otherwise start one thread per core, and together they
    oversubscribe the host.  Returns the thread count set."""
    n = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(n)
    return n
