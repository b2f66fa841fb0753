"""The (data, model) grid of ranks (port of ``vit4hep_tpu/parallel/mesh.py``).

The JAX package runs one process over every local device and partitions
each jitted program over a ``jax.sharding.Mesh``. The port keeps PyTorch's
idiom: one process per device, joined by ``torch.distributed`` (NCCL on
the card, gloo on the CPU). :func:`create_mesh` lays the world's ranks out
as JAX lays out its devices, data-major: rank ``d * model + m`` sits at
row ``d`` (its data index) and column ``m`` (its model index). Each rank
holds a process group over its row (``model_group``: the ranks that share
one batch shard and split the tensor-parallel weights) and one over its
column (``data_group``: the ranks that hold the same weights and average
their gradients). A group of one rank of several is ``None``, over which
every collective of ``_comm`` is the identity, and so is every group of a
run without a process group; a distributed run of one rank (``distributed:
true`` with ``WORLD_SIZE=1``) keeps the world group and runs its
collectives on its backend.

Batches follow JAX's multi-process rule (``:47-79``): every rank draws the
same host batch (the same seed gives the same loader stream) and keeps its
data row's contiguous chunk of rows (:func:`shard_batch`).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from vit4hep_tpu_torch.parallel import _comm

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(backend=None, device="cuda", init_method=None, rank=None,
                     world_size=None, timeout_s=600):
    """Join the process group of a multi-process run; returns ``(rank,
    world_size, device)``.

    ``rank``, ``world_size`` and the rendezvous come from the arguments, else
    from the torchrun variables ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (as JAX ``main.py:80-100`` reads them).
    A CUDA device becomes ``cuda:<LOCAL_RANK modulo the device count>``:
    ranks beyond the card count share cards. The backend is NCCL on a CUDA
    device and gloo on the CPU unless ``backend`` names one; NCCL refuses two
    ranks on one card, so ranks that share one (``LOCAL_WORLD_SIZE`` above
    the card count) must ask for gloo."""
    rank = int(os.environ["RANK"] if rank is None else rank)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed run on CUDA devices needs one; pass device=cpu")
        count = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; use backend=gloo on the CPU")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if local_world > torch.cuda.device_count():
            raise ValueError(f"{local_world} ranks share {torch.cuda.device_count()} card(s): "
                             "NCCL refuses two ranks on one device; pass backend=gloo")
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return rank, world_size, device


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier():
    if world()[1] > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``."""

    start: int
    stop: int
    total: int


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups."""

    rank: int
    grid: np.ndarray  # (data, model) global ranks
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.grid.shape[0], MODEL_AXIS: self.grid.shape[1]}

    @property
    def data(self) -> int:
        return self.grid.shape[0]

    @property
    def model(self) -> int:
        return self.grid.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    def rows(self, total: int) -> Rows:
        """This rank's chunk of a global batch of ``total`` rows."""
        if total % self.data:
            raise ValueError(f"batch axis ({total}) must divide the data axis ({self.data})")
        chunk = total // self.data
        return Rows(self.data_index * chunk, (self.data_index + 1) * chunk, total)

    def data_mean(self, t):
        """The mean of the tensor ``t`` over the data group (no gradient)."""
        return _comm.mean_over(t, self.data_group)


def _group(ranks):
    """A process group over ``ranks`` (every rank must call this for every
    group, in one order): the world group for all of them (a world of one
    included, whose collectives then run on its backend), None for one rank
    of several."""
    ranks = [int(r) for r in ranks]
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


def create_mesh(num_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) grid over the world's ranks, data-major (JAX
    ``mesh.py:25-36``). One process drives one device, so ``num_devices``
    must be None or the world size."""
    rank, n = world()
    if num_devices is not None and int(num_devices) != n:
        raise ValueError(f"num_devices={num_devices}: the port runs one process per device, "
                         f"and the world has {n}")
    model_parallel = int(model_parallel or 1)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.arange(n).reshape(n // model_parallel, model_parallel)
    if not dist.is_initialized():
        return Mesh(rank, grid)
    rows = [_group(row) for row in grid]
    cols = [_group(col) for col in grid.T]
    return Mesh(rank, grid, data_group=cols[rank % model_parallel],
                model_group=rows[rank // model_parallel])


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of every array (or tensor) of ``batch``,
    the host batch every rank holds alike."""
    if mesh.data == 1:
        return batch
    out = []
    for x in batch:
        rows = mesh.rows(len(x))
        out.append(x[rows.start:rows.stop])
    return tuple(out)


def _state_tensors(state):
    """The tensors a train state (or a module) holds alike on every rank:
    the parameters and the EMA shadow (buffers are made from the config)."""
    yield from getattr(state, "model", state).parameters()
    yield from getattr(state, "ema", None) or ()


def replicate(state, mesh: Mesh):
    """Rank 0's parameters and EMA on every rank (broadcast in
    place); returns ``state``."""
    if mesh.grid.size > 1:
        with torch.no_grad():
            for t in _state_tensors(state):
                buf = t.data.contiguous()
                dist.broadcast(buf, src=0)
                if buf.data_ptr() != t.data.data_ptr():
                    t.data.copy_(buf)
    return state


def shard_state(state, mesh: Mesh):
    """A train state placed on the grid: replicated, and with a model axis
    above 1 its transformer products split over it
    (``parallel/sharding_rules.shard_tree``)."""
    replicate(state, mesh)
    if mesh.model == 1:
        return state
    from vit4hep_tpu_torch.parallel.sharding_rules import shard_tree

    return shard_tree(state, mesh)
