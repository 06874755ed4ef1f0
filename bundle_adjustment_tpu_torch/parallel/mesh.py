"""Process groups and the device mesh (port of
``bundle_adjustment_tpu.parallel.mesh``).

Axes, as in the JAX package:
- ``win``: independent keyframe windows (or query blocks): the
  data-parallel axis;
- ``pt``: map-point shards within one BA problem: the camera system is
  summed over it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the first
``win * pt`` ranks of the default process group, one rank per shard.  The
backend follows from what the ranks hold (``backend_for``): NCCL when every
rank of a host has a card of its own; gloo when ranks share a card (one
H100 with two ranks: NCCL refuses two ranks on one device) or run on the
CPU.  Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only,
staging them through host memory itself; the port's collectives are built
from those two, and the one point-to-point exchange (``dist_match``'s ring)
moves its blocks through host memory explicitly under gloo.

``init_from_env`` joins a run started by ``torchrun`` (the CLI's
``--multihost``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from bundle_adjustment_tpu_torch import device as device_mod

AXES = ("win", "pt")


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(device_type: str, local_world_size: int) -> str:
    """"nccl" when the ranks run on cards and each of this host's
    ``local_world_size`` ranks has a card of its own, else "gloo"."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def ranks_per_card(device_type: str, local_world_size: int) -> int:
    """Ranks that share one card (0 for ranks on the CPU)."""
    if device_type != "cuda":
        return 0
    return -(-local_world_size // torch.cuda.device_count())


def make_mesh(win: int = 1, pt: int = 1, device_type: str = "cuda"):
    """A ("win", "pt") ``DeviceMesh`` over the first ``win * pt`` ranks,
    row-major (rank = w * pt + p).  Raises when ``device_type`` is "cuda"
    and no card is present, when torch.distributed is not initialized or
    when the world has fewer ranks.  Every rank of the world must call it
    (it creates the axes' groups)."""
    device_mod.resolve(device_type)
    n = win * pt
    have = world_size()
    if have < n or not dist.is_initialized():
        raise ValueError(f"a (win={win}, pt={pt}) mesh needs {n} ranks; the world has {have}"
                         + ("" if dist.is_initialized() else
                            " (torch.distributed is not initialized)"))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(win, pt), mesh_dim_names=AXES)


def default_mesh(device_type: str = "cuda"):
    """Every rank on the ``pt`` axis (one window, points sharded)."""
    return make_mesh(1, world_size(), device_type)


def shape(mesh) -> dict:
    """{"win": W, "pt": P}."""
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(mesh.mesh_dim_names.index(axis)))


def init_from_env(device="cuda"):
    """Join the process group of a ``torchrun`` launch (``env://``: RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
    Each rank takes ``cuda:{LOCAL_RANK % device_count}``, or the CPU when
    ``device`` says so; the backend is ``backend_for``'s, and printed.
    Returns (device, {"backend", "world_size", "rank", "ranks_per_card"})."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"--multihost needs the environment torchrun sets ({e.args[0]} "
                           "missing): RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT") from None
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend_for(dev.type, local_world)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    info = dict(backend=backend, world_size=world, rank=rank,
                ranks_per_card=ranks_per_card(dev.type, local_world))
    print(f"torch.distributed: rank {rank} of {world} on {dev}, backend {backend}, "
          f"{info['ranks_per_card']} ranks per card")
    return dev, info


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
