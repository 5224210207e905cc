"""Start N ranks on this host: fresh interpreters (the ``spawn`` start
method) joined in one process group through a file store, each running one
function of the package and handing back what it returns.

The tests and ``chip_smoke.py`` drive the data-parallel path with it: the
ranks import torch and this package only.  A user's run is started by
torchrun instead (``parallel/launch.py``).

    ranks = start_ranks(fn, 2, work_dir, args=(...,))
    ...                      # the caller works meanwhile
    results = ranks.join()   # [rank 0's return value, rank 1's]
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _result(work: str, rank: int) -> str:
    return os.path.join(work, f"rank{rank}.pt")


def _error(work: str, rank: int) -> str:
    return os.path.join(work, f"rank{rank}.err")


def _entry(target: Callable, rank: int, world: int, work: str,
           backend: str, threads: int, args: Sequence) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(work, "store"),
            rank=rank, world_size=world)
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        torch.save(out, _result(work, rank))
    except BaseException:
        with open(_error(work, rank), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """The started ranks; :meth:`join` waits for them."""

    def __init__(self, procs: List[mp.Process], work: str, timeout: float):
        self.procs, self.work = procs, work
        self.deadline = time.monotonic() + timeout

    def join(self) -> List[Any]:
        """Each rank's return value, in rank order; raises with the ranks'
        tracebacks if one failed, and stops every rank if the time ran
        out."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        late = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(self.procs):
            if os.path.exists(_error(self.work, r)):
                with open(_error(self.work, r)) as f:
                    errors.append(f"rank {r}:\n" + f.read())
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if late or errors:
            raise RuntimeError(
                (f"ranks {late} ran out of time\n" if late else "")
                + "\n".join(errors))
        return [torch.load(_result(self.work, r), weights_only=False)
                for r in range(len(self.procs))]


def start_ranks(target: Callable, world: int, work: str, args: Sequence = (),
                backend: str = "gloo", threads: int = 0,
                timeout: float = 600.0) -> Ranks:
    """Start ``world`` ranks, each calling ``target(*args)`` (an importable
    function) after joining a ``backend`` group whose store is a file in
    ``work`` (an empty directory); ``threads`` > 0 sets each rank's torch
    threads.  Returns at once."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, work,
                                              backend, threads, tuple(args)),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, work, timeout)


def run_ranks(target: Callable, world: int, work: str, args: Sequence = (),
              **kw) -> List[Any]:
    """:func:`start_ranks`, then :meth:`Ranks.join`."""
    return start_ranks(target, world, work, args, **kw).join()
