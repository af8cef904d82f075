"""Device mesh helpers (PyTorch port of tengine_tpu/parallel/mesh.py).

The reference's scale axes are big/LITTLE CPU clusters + NPU offload
(system/cpu.c, optimizer/split.c). The port's equivalents are the axes of a
torch.distributed DeviceMesh over the ranks of the job, one process per
card: "data" (batch replication / DP serving), over which requests are
sharded, and "model" (TP), over which large conv/FC weights are sharded by
output channel (parallel/sharding.py inserts the channel all-gathers).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..executor.engine import resolve_device


def make_mesh(
    ranks: Optional[Sequence[int]] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    device=None,
) -> DeviceMesh:
    """A 2-D (data, model) mesh over the given ranks (all of the job's by
    default), on the device type of `device` (the one init_distributed
    took when None). Needs an initialized process group (init_distributed).

    The default factorization puts every rank on "model" (weights of the
    conv nets we serve shard well over output channels; batch-1 latency
    serving can't use DP), i.e. shape (1, n) unless specified."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
    n = len(ranks)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if device is None:
        from .distributed import state

        device = state().device
    device_type = resolve_device(device).type
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def data_sharding(mesh: DeviceMesh, ndim: int) -> Tuple:
    """Batch-sharded activation: dim 0 over "data", replicated over "model"
    (the placements of a DTensor of rank `ndim`)."""
    if ndim < 1:
        raise ValueError("a batch-sharded tensor has a batch dimension")
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(), Replicate())
