"""Device meshes and batch placement on ``torch.distributed`` (counterpart of
``ssp_x_vit_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
package's axis names:

- ``data``  — batch data parallelism (calibration / eval / training batches)
- ``model`` — tensor parallelism (attention heads, FFN columns, vocab)
- ``pipe``  — pipeline stages (``make_pipeline_mesh``: ``(data, pipe, model)``)
- ``seq``   — the ring of sequence parallelism (``make_seq_mesh``: ``(data, seq)``)
- ``expert`` — expert parallelism (``make_expert_mesh``: ``(data, expert)``)

The last axis is the inner dimension, so a model group is made of neighbouring
ranks, as ``make_mesh`` lays out JAX devices. The port runs one process per
card (the JAX package drives every device from one process): a process joins
its world through :func:`init_distributed`, which follows the ``torchrun``
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) and picks NCCL for ``cuda``, gloo for ``cpu``.
``torch.distributed.run`` starts such a world (``auto_2ssp --data-parallel``
does so itself on more than one card).
Importing this module creates no process group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")
PIPELINE_AXES = ("data", "pipe", "model")
SEQ_AXES = ("data", "seq")
EXPERT_AXES = ("data", "expert")
_ENV = ("RANK", "WORLD_SIZE")


def distributed_env() -> bool:
    """True when the torchrun environment names this process's rank."""
    return all(k in os.environ for k in _ENV)


def init_distributed(device: str = "cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None) -> Tuple[int, int]:
    """Join the process group (once per process) -> (rank, world size).

    ``rank`` / ``world_size`` / ``init_method`` default to the torchrun
    environment (``env://``); without it a world of one is made on an
    in-memory store. ``device="cuda"`` selects the card ``LOCAL_RANK`` (before
    any kernel: the ctypes-bound kernels launch on the current device) and
    NCCL; ``"cpu"`` gloo."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if device == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if rank is None and world_size is None and init_method is None and not distributed_env():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kw)
    return dist.get_rank(), dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """(data, model) mesh over the ranks of the world; ``data=None`` uses all
    remaining ranks. A mesh smaller than the world takes its first ranks
    (the others have no coordinate on it)."""
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    grid = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(_device_type(), grid, mesh_dim_names=AXES)


def make_hybrid_mesh(n_hosts: int, ici_data: int = 1, model: int = 1) -> DeviceMesh:
    """(data, model) mesh over ``n_hosts`` hosts of ``ici_data * model`` cards
    each: hosts are the outermost stride of ``data`` and ``model`` stays
    within a host, so tensor-parallel collectives never cross hosts. torchrun
    numbers ranks host-major, so the grid is the plain reshape; the host count
    is read from ``LOCAL_WORLD_SIZE`` where torchrun sets it."""
    per_host = ici_data * model
    n = n_hosts * per_host
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"hybrid mesh {n_hosts} hosts x ({ici_data}x{model}) needs {n} "
                         f"devices, have {world}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(1, world // max(1, local))
    if hosts > 1 and hosts != n_hosts:
        raise ValueError(f"n_hosts={n_hosts} but ranks span {hosts} hosts")
    grid = torch.arange(n).reshape(n_hosts * ici_data, model)
    return DeviceMesh(_device_type(), grid, mesh_dim_names=AXES)


def _named_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of the world's first ranks in row-major order, refused (JAX's
    message) when the world is too small."""
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_pipeline_mesh(data: int = 1, pipe: int = 2, model: int = 1) -> DeviceMesh:
    """(data, pipe, model) mesh of the pipeline (JAX ``parallel/pipeline.py``)."""
    return _named_mesh((data, pipe, model), PIPELINE_AXES)


def make_seq_mesh(data: int = 1, seq: int = 1) -> DeviceMesh:
    """(data, seq) mesh of ring-attention sequence parallelism."""
    return _named_mesh((data, seq), SEQ_AXES)


def make_expert_mesh(data: int = 1, expert: int = 1) -> DeviceMesh:
    """(data, expert) mesh of expert parallelism."""
    return _named_mesh((data, expert), EXPERT_AXES)


def _axis(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh {names} has no axis {axis!r}")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_axis(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (raises off the mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    return coord[_axis(mesh, axis)]


def batch_sharding(mesh: DeviceMesh, ndim: int) -> Tuple[Optional[str], ...]:
    """The spec of a batch: leading axis over ``data``, the rest replicated."""
    return ("data",) + (None,) * (ndim - 1)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` broadcast from the mesh's first rank in place,
    so every rank holds the same bytes; the tree itself back."""
    src = int(mesh.mesh.reshape(-1)[0])
    group = None if mesh.mesh.numel() == dist.get_world_size() else \
        dist.new_group(mesh.mesh.reshape(-1).tolist())

    def visit(t):
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)
        elif isinstance(t, torch.Tensor):
            dist.broadcast(t, src=src, group=group)

    with torch.no_grad():
        visit(tree)
    return tree


def shard_batch(mesh: DeviceMesh, batch):
    """This rank's rows of every tensor of a batch dict (leading axis split
    over ``data`` by the rank's data coordinate); refuses a leading size that
    ``data`` does not divide."""
    dp, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % dp:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over data={dp}")
        n = x.shape[0] // dp
        return x[i * n:(i + 1) * n]

    return {k: rows(v) for k, v in batch.items()}
