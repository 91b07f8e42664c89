"""Start a world of ranks on one host: one spawned process per rank,
joined in one ``torch.distributed`` process group.

``run_ranks(fn, world, *args)`` calls ``fn(rank, world, *args)`` in each
process and returns the results by rank.  The ranks meet through a file
(``init_method="file://..."``) in a fresh directory, never a fixed port,
so several worlds can run side by side; each rank runs torch on one
thread (ranks that share a host's cores and spin on barriers with
several threads each run several times slower).
A rank that raises fails the call with its traceback, and a world that
outlives ``timeout`` seconds is killed and fails the call: a hung rank
never hangs the caller.  ``fn`` must be importable by name (a module's
top-level function).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _rank_main(fn, rank: int, world: int, rdv: str, backend: str,
               timeout: float, out, args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{rdv}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world, *args)
        # no rank leaves while another still works: a group being made
        # still talks to every rank of the world
        dist.barrier()
        out.put((rank, True, result))
    except Exception:                           # reported to the caller
        out.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo",
              timeout: float = 300.0) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    in its own process of one ``world``-rank process group."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, os.path.join(tmp, "rdv"), backend, timeout, out,
        args)) for r in range(world)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * world
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            left = deadline - time.monotonic()
            try:
                rank, ok, value = out.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did "
                                   f"not finish in {timeout:.0f} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
