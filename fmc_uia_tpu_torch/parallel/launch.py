"""A local launcher: W processes on this host, one process group.

The counterpart of JAX's single controller driving a mesh of local
devices, for the tests and ``chip_smoke.py``: ``run_local(fn, world)``
spawns ``world`` processes, joins them through a ``FileStore`` in a fresh
temporary directory (no TCP port to race for), runs ``fn(rank, world,
*args)`` in each and returns the ranks' results in rank order. Each run
has a deadline: when a rank fails or the deadline passes, every child is
killed and the parent raises (the failing rank's traceback, or a
``TimeoutError``), so a hang never outlives its run.

``fn`` must be importable by name (a module-level function) and its
result picklable. Under ``device="cuda"`` a child raises when CUDA is
absent; it never runs on the CPU instead.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional


def _child(fn, rank: int, world: int, backend: str, store_path: str,
           out_path: str, args, device: Optional[str], threads: int,
           timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    ok, payload = False, None
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA was asked for and is not available")
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=max(30, timeout_s)))
        payload = fn(rank, world, *args)
        ok = True
    except BaseException:
        payload = traceback.format_exc()
    finally:
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump((ok, payload), f)
        os.replace(out_path + ".tmp", out_path)
        try:
            if dist.is_initialized():
                if ok:
                    dist.barrier()
                dist.destroy_process_group()
        except BaseException:
            pass
    os._exit(0 if ok else 1)


def run_local(fn: Callable, world: int, backend: str = "gloo",
              timeout_s: float = 120.0, args=(), device: Optional[str] = None,
              threads: int = 1) -> List:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    process of one ``backend`` process group; raises when a rank fails or
    ``timeout_s`` passes (every child killed first)."""
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="run_local_")
    store = os.path.join(work, "store")
    outs = [os.path.join(work, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_child, daemon=True, args=(
        fn, r, world, backend, store, outs[r], tuple(args), device, threads,
        timeout_s)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_local({getattr(fn, '__name__', fn)}, world={world})"
                    f" passed its {timeout_s:.0f} s deadline; ranks still "
                    f"running: {[r for r, c in enumerate(codes) if c is None]}")
            time.sleep(0.05)
        if failed:
            msgs = []
            for r in failed:
                try:
                    with open(outs[r], "rb") as f:
                        msgs.append(f"rank {r}:\n{pickle.load(f)[1]}")
                except OSError:
                    msgs.append(f"rank {r}: exit code {codes[r]}, no result")
            raise RuntimeError("run_local: " + "\n".join(msgs))
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
