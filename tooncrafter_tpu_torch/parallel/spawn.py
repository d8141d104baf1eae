"""Run a function on N ranks, each a spawned process joined over a
``file://`` store (``torch.distributed``), and collect what each returns.

    results = run_ranks(fn, 2, "cpu", args=(...,), timeout=120)

``fn(d, *args)`` runs in every rank with ``d`` its ``mesh.Dist``; what it
returns comes back to the caller through a file (``torch.save`` beside
the store, read back by the caller: return CPU tensors or numpy arrays).
A rank that
raises, exits non-zero or outlives ``timeout`` fails the run: every rank is
stopped and ``RuntimeError`` raised with the first traceback. The ranks
join over gloo; on CUDA they share ``cuda:0`` (NCCL refuses two ranks on
one card). Spawned children import the caller's
modules afresh: ``fn`` must live in an importable module of the port.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, device, store, threads, args,
               results) -> None:
    import torch.distributed as dist

    from tooncrafter_tpu_torch.parallel import mesh as M

    try:
        if threads:
            torch.set_num_threads(threads)
        d = M.init_distributed(device, backend="gloo",
                               init_method=f"file://{store}", rank=rank,
                               world_size=world,
                               local_rank=0 if device != "cpu" else None)
        try:
            out = fn(d, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(os.path.dirname(store), f"result{rank}.pt")
        torch.save(out, path)
        results.put((rank, True, path))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, world: int, device: str = "cpu",
              args: Sequence[Any] = (), timeout: float = 300.0,
              threads: Optional[int] = None,
              store_dir: Optional[str] = None) -> List[Any]:
    """``fn(d, *args)`` on ``world`` spawned ranks; rank r's return value
    at index r. ``threads`` sets each rank's torch threads; the store lives
    in a fresh temporary directory (under ``store_dir`` when given)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, device, store, threads,
                                   tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and failed is None:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode]
                try:  # a dead rank's traceback may still be on its way
                    rank, ok, out = results.get(timeout=5.0 if dead else 1.0)
                except queue_mod.Empty:
                    if dead:
                        failed = (f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        failed = (f"ranks {sorted(set(range(world)) - set(got))}"
                                  f" still running after {timeout:.0f} s")
                    continue
                if ok:  # written by the rank itself
                    got[rank] = torch.load(out, weights_only=False)
                else:
                    failed = f"rank {rank} raised:\n{out}"
            for p in procs:
                p.join(timeout=30.0 if failed is None else 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        raise RuntimeError(failed)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited non-zero: {bad}")
    return [got[r] for r in range(world)]
