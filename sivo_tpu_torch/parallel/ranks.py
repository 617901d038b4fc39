"""Ranks of a ``torch.distributed`` process group, one spawned process
each (the port's counterpart of a ``jax.sharding.Mesh`` axis).

``spawn`` starts ``n_ranks`` processes with the ``spawn`` start method.
They meet through a ``file://`` store in a fresh temporary directory,
never a TCP port, so that concurrent runs on one machine cannot collide.
Rank ``r`` runs on ``devices[r]`` (``torch.cuda.set_device`` for a card)
and calls ``fn(rank, device, *args)``; what it returns is saved with
``torch.save`` and read back in rank order. A rank that raises fails the
whole call (``torch.multiprocessing.spawn`` stops the others and raises
its traceback).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn: Callable[..., Any], n_ranks: int, args: tuple = (), *,
          backend: str, devices: Sequence[str | torch.device]) -> list:
    """Run ``fn(rank, device, *args)`` on ``n_ranks`` spawned ranks of one
    process group (``backend``: "nccl" or "gloo"); returns their results
    in rank order. ``fn`` must be importable by name (a module-level
    function): the ranks are fresh interpreters."""
    if len(devices) != n_ranks:
        raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
    with tempfile.TemporaryDirectory(prefix="sivo_ranks_") as tmp:
        mp.spawn(_rank_main, args=(fn, n_ranks, backend,
                                   [str(d) for d in devices], tmp, args),
                 nprocs=n_ranks, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]


def _rank_main(rank: int, fn, n_ranks: int, backend: str,
               devices: list[str], tmp: str, args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        world_size=n_ranks, rank=rank)
    try:
        out = fn(rank, device, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
