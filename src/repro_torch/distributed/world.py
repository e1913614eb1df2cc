"""Start a world of ranks in child processes and collect what each returns.

:func:`spawn_world` is the port's counterpart of the reference's forced
host-device count (``XLA_FLAGS=--xla_force_host_platform_device_count``):
the reference is one process over many devices, the port one process per
rank. The ranks start from ``torch.multiprocessing``'s spawn context, read
the call from a file in a temporary directory, meet through a ``file://``
store there and run ``fn(*args)`` after ``init_process_group``; each rank's
result is pickled back to the caller. A rank that raises, or a world that has not finished within
``timeout_s``, makes :func:`spawn_world` raise; every rank it started is
ended before it returns or raises.

``fn`` must be importable by the children (a module-level function, or a
``functools.partial`` of one). :func:`call_each` runs several calls in one
world, so one start-up serves many cases.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_world", "call_each"]


def call_each(calls):
    """``[fn(*args, **kwargs) for fn, args, kwargs in calls]``, on each rank."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def _rank_main(rank: int, world_size: int, backend: str, tmp: str, timeout_s: float,
               results) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # plain pickle bytes: a tensor's data travels in them, not in shared
        # memory that would leave with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # the traceback goes to the caller, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn, world_size: int, backend: str = "gloo", timeout_s: float = 120.0,
                args: tuple = ()) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks of a ``backend`` process
    group and return their results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-torch-world-") as tmp:
        # the call reaches the ranks in a file, so each start sends a few bytes
        # and does not wait while a rank imports what unpickling the call needs:
        # the ranks start side by side
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, tmp, timeout_s, results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                try:
                    wait = min(1.0, max(0.05, deadline - time.monotonic()))
                    rank, ok, out = results.get(timeout=wait)
                except queue.Empty:
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"spawn_world: ranks {sorted(set(range(world_size)) - set(got))} "
                            f"of {world_size} did not finish within {timeout_s} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"spawn_world: rank {dead[0]} ended with exit code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn_world: rank {rank} of {world_size} raised:\n{out}")
                got[rank] = pickle.loads(out)
        finally:
            for p in procs:
                p.join(timeout=10 if len(got) == world_size else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world_size)]
