"""Ranks on this host in fresh processes, for the tests and ``chip_smoke.py``
(a run of the CLI across ranks is started by ``torchrun`` instead).

``run_ranks`` spawns them with ``torch.multiprocessing.start_processes``,
gives each the environment ``torchrun`` would and, unless asked not to,
joins them in one process group.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch.parallel.mesh import backend_for, free_port


def _rank_main(rank: int, world: int, port: int, device_type: str, join: bool, fn, args,
               out_dir: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
    if join:
        dist.init_process_group(backend_for(device_type, world),
                                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank)
    try:
        value = fn(*args)
    finally:
        if join:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
        pickle.dump(value, fh)


def run_ranks(fn, world: int, *args, device_type: str = "cuda", timeout: float = 120.0,
              join: bool = True) -> list:
    """``fn(*args)`` in ``world`` spawned processes, each with RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT (a
    free port) set and, with ``join``, joined in one group over TCP with the
    backend ``backend_for(device_type, world)``; without it ``fn`` joins by
    itself (``mesh.init_from_env``, the CLI's ``--multihost``).  On the card
    (the default; raises when there is none) every rank takes
    ``cuda:{rank % device_count}``.  ``fn`` must be importable by name and
    return a picklable value.  Returns the values in rank order; raises with
    the rank's traceback when one fails, and after ``timeout`` seconds.
    Every process has ended when it returns."""
    device_type = device_mod.resolve(device_type).type
    with tempfile.TemporaryDirectory(prefix="run_ranks_") as out_dir:
        ctx = mp.start_processes(_rank_main, nprocs=world, join=False,
                                 args=(world, free_port(), device_type, join, fn, args, out_dir))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks did not finish in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        values = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as fh:
                values.append(pickle.load(fh))
    return values
