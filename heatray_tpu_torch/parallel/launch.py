"""Start a group of ranks on one host and collect what each returns.

``spawn(scenario, world, store_dir, *args)`` starts ``world`` processes with
``torch.multiprocessing``'s spawn method.  Each joins the default process
group through a ``file://`` store in ``store_dir`` (no TCP port), runs
``scenario(*args)`` and ``torch.save``s what it returns to ``rank<r>.pt``.
``Ranks.results()`` waits for them; the caller may work meanwhile.  A
collective that waits past ``timeout_s`` fails its rank, a rank that fails
fails ``results()``, and no rank outlives the group's deadline, so a hung
rank fails the caller instead of stalling it.

A spawned rank unpickles ``scenario`` by module: it must live in a module
that a fresh process imports cheaply (not one that imports jax).  Each rank
starts with ``OMP_NUM_THREADS=1`` unless the caller's environment sets it,
as ``torchrun`` starts more than one rank on a host; that bounds both
torch's thread pool and numpy's BLAS.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from .sharding import initialize_distributed


def _entry(rank: int, world: int, store_dir: str, backend: str, device: str,
           timeout_s: float, scenario, args: tuple) -> None:
    initialize_distributed(f"file://{store_dir}/store", world, rank, backend=backend,
                           device=device, timeout_s=timeout_s)
    try:
        torch.save(scenario(*args), os.path.join(store_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """A started group; ``results()`` waits for it."""

    def __init__(self, ctx, world: int, store_dir: str, deadline: float):
        self.ctx, self.world, self.store_dir, self.deadline = ctx, world, store_dir, deadline

    def results(self) -> list:
        """What each rank's scenario returned, by rank; raises if a rank
        failed or the group outlived its deadline, and kills every rank
        still running either way."""
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.world} ranks still running past their deadline")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(self.store_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def spawn(scenario, world: int, store_dir, *args, backend: str = "gloo", device="cuda",
          timeout_s: float = 120.0, deadline_s: float | None = None) -> Ranks:
    """Start ``world`` ranks running ``scenario(*args)`` in a group of
    ``backend`` over ``device`` (the card unless the caller asks for "cpu";
    several ranks on one card need "gloo");
    ``timeout_s`` bounds each collective, ``deadline_s`` (default twice
    that) the whole group."""
    import torch.multiprocessing as mp

    store_dir = str(store_dir)
    deadline = time.monotonic() + (2 * timeout_s if deadline_s is None else deadline_s)
    # The children read the environment at start.
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = saved or "1"
    try:
        ctx = mp.start_processes(
            _entry, args=(world, store_dir, backend, str(device), timeout_s, scenario, args),
            nprocs=world, join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
    return Ranks(ctx, world, store_dir, deadline)
