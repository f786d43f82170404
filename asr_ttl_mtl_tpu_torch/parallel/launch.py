"""Run one function on several ranks of a fresh process group, each rank a
spawned process, and bring back what each rank returns.

torchrun is the launcher for users; this is for a script or a test that
drives the multi-device paths from one process: the ranks meet through a
`FileStore` (no TCP port to clash), run `fn(rank, *args)`, and send back
its result, which must pickle (numbers, numpy arrays, CPU tensors). A rank
that raises fails the whole run, with its traceback; a run that outlasts
`timeout` seconds is killed.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, List, Optional


def _rank_main(rank: int, world: int, backend: str, store_path: str, threads: Optional[int],
               fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        out = fn(rank, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo", timeout: float = 600.0,
              threads: Optional[int] = None, store_dir: Optional[str] = None) -> List[Any]:
    """fn(rank, *args) on `world` spawned ranks of one process group; the
    results in rank order. `fn` must be importable by name (a module-level
    function)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, backend, store_path, threads, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            while len(got) + len(errors) < world:
                try:
                    rank, ok, out = results.get(timeout=timeout)
                except queue_mod.Empty:
                    raise TimeoutError(f"run_ranks: no result from {world - len(got) - len(errors)} rank(s) "
                                       f"within {timeout} s") from None
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("a rank failed\n" + "\n".join(errors))
    return [got[r] for r in range(world)]
