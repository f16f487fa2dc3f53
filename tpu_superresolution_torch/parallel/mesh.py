"""Process groups, batch sharding and replication for data parallelism
(port of ``tpu_superresolution_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``jax.sharding.Mesh`` over the devices one
process drives.  Here a device is a process (one rank a GPU, started by
``torchrun``): the mesh is the process group over the first `dp` ranks,
a sharded batch is this rank's contiguous rows of the global batch (how
``NamedSharding(P('dp'))`` splits axis 0), and replication is a
broadcast from rank 0.  NCCL carries the collectives between GPUs, gloo
between CPU processes (the tests, ``entry.dryrun_multichip``); the
backend follows the device the caller names, or the caller names it
(two ranks on one GPU take gloo, since NCCL refuses that).  On gloo a
CUDA tensor goes through a host copy.

Every collective that writes a parameter or buffer goes through a flat
scratch buffer and ``copy_`` back: a collective writes its tensor in
place without moving the tensor's version counter, and
``models.blocks.DerivedCache`` (the kernels' packed weights, DAT's
folded BatchNorm) keys on those counters.

``batch_spec`` / ``replicated_spec`` have no counterpart: a rank holds
plain tensors.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device]
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: `group` (None: the default group) over
    `size` ranks, this process's `rank` in it (-1 outside it), the
    `device` its tensors live on and the group's `backend`."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str


def backend_for(device: Device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_world_size() -> int:
    """The process group's size, or torchrun's ``WORLD_SIZE`` before it
    is initialised; 1 in a process that no launcher started."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device: Optional[Device] = None) -> torch.device:
    """This rank's device under torchrun: ``cuda:LOCAL_RANK`` (made the
    current CUDA device), or the CPU when the caller names it.  Without
    a CUDA device a CUDA request raises (``core.device.resolve_device``)."""
    from tpu_superresolution_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def init_multihost(device: Optional[Device] = None, init_method: Optional[str] = None,
                   world_size: Optional[int] = None, rank: Optional[int] = None,
                   backend: Optional[str] = None) -> int:
    """Initialise the default process group and return its size.

    Without `init_method` it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``);
    a process no launcher started is left alone (world size 1).  An
    explicit `init_method` (a ``file://`` store in the tests, a
    ``tcp://localhost:PORT``) takes `world_size` and `rank`.  `backend`
    defaults to ``backend_for(device)`` (`device` None: the CPU).  A
    process already initialised is left as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return 1
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kw = {} if init_method is None else dict(init_method=init_method,
                                            world_size=world_size or 1, rank=rank or 0)
    dist.init_process_group(backend or backend_for(dev), timeout=TIMEOUT, **kw)
    return dist.get_world_size()


def make_mesh(dp: Optional[int], device: Device) -> Mesh:
    """The mesh over the first `dp` ranks (None or <= 0: every rank), its
    tensors on `device`.  Every rank of the default group calls it
    (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with `torchrun "
                           "--nproc_per_node N` (or call init_multihost first)")
    world = dist.get_world_size()
    if dp is None or dp <= 0:
        dp = world
    if dp > world:
        raise ValueError(f"requested dp={dp} > available ranks {world}")
    group = None if dp == world else dist.new_group(list(range(dp)))
    rank = dist.get_rank()
    # a new group takes the default group's backend
    return Mesh(group, rank if rank < dp else -1, dp, torch.device(device), dist.get_backend())


def is_writer() -> bool:
    """Whether this process writes files and logs: rank 0, or a process
    with no process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def shard_batch(batch, mesh: Mesh):
    """This rank's rows [r B/dp, (r+1) B/dp) of each array or tensor in
    `batch` (one, or a tuple / list of them).  B must split evenly."""
    if mesh.rank < 0:
        raise ValueError("shard_batch: this rank is outside the mesh")

    def rows(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} rows does not split over {mesh.size} ranks")
        k = n // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    if isinstance(batch, (tuple, list)):
        return tuple(rows(x) for x in batch)
    return rows(batch)


# ------------------------------------------------------------ collectives


def _staged(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`flat` as the group's backend takes it: a host copy on gloo."""
    return flat.cpu() if mesh.backend == "gloo" and flat.is_cuda else flat


def all_reduce_sum_(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SUM the scratch buffer `flat` over the mesh in place; returns it."""
    buf = _staged(flat, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    if buf is not flat:
        flat.copy_(buf)
    return flat


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order:
    ``all_gather_into_tensor`` on NCCL, ``all_gather`` of a list on gloo."""
    t = t.contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    src = _staged(t, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def _groups(tensors: Sequence[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    """`tensors` by (dtype, device)."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


def flat_copy_(tensors: Sequence[torch.Tensor], flat: torch.Tensor,
               scale: Optional[float] = None) -> None:
    """Write consecutive slices of `flat` into `tensors` (one multi-tensor
    ``copy_``, which moves each tensor's version counter), times `scale`
    if given."""
    if not tensors:
        return
    if scale is not None:
        flat = flat * scale
    pieces = [piece.view(t.shape) for t, piece in
              zip(tensors, torch.split(flat, [t.numel() for t in tensors]))]
    with torch.no_grad():
        torch._foreach_copy_(list(tensors), pieces)


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite `tensors` with rank `src`'s values: one flat buffer a
    dtype and device, sent from the mesh's device, copied back with
    ``copy_``."""
    for (_, device), group in _groups(tensors).items():
        flat = torch.cat([t.detach().reshape(-1) for t in group]).to(mesh.device)
        buf = _staged(flat, mesh)
        dist.broadcast(buf, src=src, group=mesh.group)
        flat_copy_(group, buf.to(device))


def state_tensors(obj) -> List[torch.Tensor]:
    """The tensors `replicate` broadcasts: a module's parameters and
    buffers; of a ``train.engine.TrainState`` also its EMA and the
    optimizer state's tensors."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    out = state_tensors(obj.model)
    if obj.ema is not None:
        out += [obj.ema[k] for k in sorted(obj.ema)]
    for p in obj.params:
        for k, v in sorted(obj.optimizer.state.get(p, {}).items()):
            if torch.is_tensor(v):
                out.append(v)
    return out


def replicate(obj, mesh: Mesh):
    """Broadcast a module's or a TrainState's tensors (``state_tensors``)
    from rank 0, so that every rank starts from rank 0's state; returns
    `obj`."""
    broadcast_(state_tensors(obj), mesh)
    return obj


def fold_seed(seed: int, rank: int) -> int:
    """A 63-bit seed for `rank` from a shared `seed` (the counterpart of
    ``jax.random.fold_in(key, axis_index)``)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0]) >> 1


def rank_generator(generator: Optional[torch.Generator], rank: int) -> torch.Generator:
    """This rank's generator for one step: every rank draws the same seed
    from the shared `generator` (None: torch's default), which keeps the
    shared stream in lockstep, and folds in its rank."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(fold_seed(seed, rank))

