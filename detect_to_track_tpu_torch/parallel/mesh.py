"""data parallelism over torch.distributed (port of the JAX package's
`parallel/mesh.py`, with JAX's names and torch.distributed bodies).

One process per card, the torch idiom, and JAX's semantics mapped onto it:
- NUM_DEVICES is the world size. Every rank holds the whole model and its
  optimizer state; DistributedDataParallel all-reduces (means) the
  gradients, and the step's losses are all-reduced too, so every rank
  reports the global batch's losses and takes the same NaN decision.
- NUM_HOSTS is the number of host groups; rank r's host is
  r // (NUM_DEVICES / NUM_HOSTS).
- BATCH_SIZE is the batch per host. The host's ranks split it in order, as
  JAX's `shard_batch` splits a process's batch over its local devices, so
  NUM_DEVICES 2, NUM_HOSTS 1 trains the single-process step's batch.

`init_distributed` sets the process group up from the variables torchrun
sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or from an
explicit init_method such as a `file://` store. The backend is NCCL for
CUDA devices and gloo for the CPU; another only when the caller names it
(two ranks that share one card need gloo: NCCL refuses a duplicate GPU).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh(NamedTuple):
    """this process's place in the data-parallel layout."""

    world_size: int
    rank: int
    n_hosts: int
    collective: bool  # a process group is up (collectives run, even at world size 1)

    @property
    def per_host(self) -> int:
        return self.world_size // self.n_hosts

    @property
    def host(self) -> int:
        return self.rank // self.per_host

    @property
    def local_index(self) -> int:
        return self.rank % self.per_host


def rank_device(device=None) -> torch.device:
    """this rank's device: `cuda` with no index (the default) is
    cuda:{LOCAL_RANK}; an explicit index or the CPU is taken as given.
    Raises when there is no card or the rank's card does not exist."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"this rank's device {dev} does not exist: {torch.cuda.device_count()} CUDA device(s)")
    return dev


def launched() -> bool:
    """True in a process that a launcher started as one rank of a group
    (torchrun sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(
    device: torch.device,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """join the process group: NCCL for a CUDA device, gloo for the CPU,
    unless `backend` names another. `init_method` defaults to env:// (the
    launcher's variables); rank and world size default to RANK and
    WORLD_SIZE. The store's keys carry the restart count (D2T_RESTARTS,
    which the watchdog's exec-restart raises), so a restarted group never
    reads the keys of the one before it."""
    if _group_up():
        raise RuntimeError("a process group is already initialized")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    rank = int(os.environ.get("RANK", "-1")) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "-1")) if world_size is None else world_size
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(init_method or "env://", rank, world_size, timeout=timeout))
    store = dist.PrefixStore(f"d2t/{os.environ.get('D2T_RESTARTS', '0')}/", store)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=timeout)


def make_mesh(n_devices: Optional[int] = None, n_hosts: int = 1) -> Mesh:
    """the rank layout, checked against NUM_DEVICES and NUM_HOSTS: the
    world size must equal n_devices (a process without a group is a world
    of one), and n_hosts must divide it."""
    up = _group_up()
    world = dist.get_world_size() if up else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"NUM_DEVICES={n} must equal the world size, {world}: one process per device "
            f"(launch with torchrun --nproc-per-node {n}, or set NUM_DEVICES to the world size)"
        )
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"NUM_HOSTS={n_hosts} must divide the world size {world}")
    return Mesh(world, dist.get_rank() if up else 0, n_hosts, up)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """broadcast the module's parameters and buffers from rank 0, in
    place; returns the module."""
    if mesh.collective:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = dataclasses.fields(tree)
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name)) for f in fields})
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """this rank's rows of the host batch (every array's leading axis): the
    host's ranks split it in order, as JAX's P("data") sharding does."""

    def rows(a):
        n = a.shape[0]
        if n % mesh.per_host:
            raise ValueError(f"a host batch of {n} rows does not split over {mesh.per_host} ranks")
        per = n // mesh.per_host
        return a[mesh.local_index * per : (mesh.local_index + 1) * per]

    return _tree_map(rows, batch)


def local_value(tree: Any) -> Any:
    """the host value of a (replicated) result: every tensor as a numpy
    array, through tuples, lists, dicts and dataclasses."""
    return _tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree)


def barrier_sync(name: str = "d2t_barrier", timeout_ms: int = 600_000) -> None:
    """wait until every rank arrives, for at most timeout_ms; a no-op
    without a process group. Raises naming the barrier on a timeout."""
    if not _group_up():
        return
    kw = {"device_ids": [torch.cuda.current_device()]} if dist.get_backend() == "nccl" else {}
    work = dist.barrier(async_op=True, **kw)
    try:
        work.wait(timeout=timedelta(milliseconds=timeout_ms))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: not every rank arrived within {timeout_ms} ms") from e


def mean_over_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """the mean of `t` over the ranks (a new tensor; `t` itself without a
    group). Equal shards make the mean of per-rank batch means the global
    batch mean."""
    if not mesh.collective:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out / mesh.world_size


def any_over_ranks(flag: bool, mesh: Mesh, device: torch.device) -> bool:
    """True on every rank when `flag` is True on any rank."""
    if not mesh.collective:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def make_parallel_train_step(model, cfg, optimizer, mesh: Mesh, device=None):
    """the data-parallel trainer.make_train_step: the joint loss runs
    inside DistributedDataParallel (its backward all-reduces the gradients)
    on this rank's rows, and the returned DTLoss is the mean over the ranks.
    Every rank keeps its own copy of the parameters and the momentum; equal
    gradients keep them equal."""
    from ..trainer import make_train_step

    return make_train_step(model, cfg, optimizer, device, mesh=mesh)


def make_parallel_detect(model, cfg, mesh: Mesh, device=None) -> Callable:
    """batched pair detection over the ranks: fn(images (P, 2, H, W, C) the
    host batch, anchors) runs this rank's rows (shard_batch) and
    all-gathers the PairDetections, so every rank returns the global batch
    in rank order. The model must be the same on every rank (`replicate`)."""
    from ..inference import PairDetections, detect_pairs_batched

    def detect(images, anchors) -> PairDetections:
        out = detect_pairs_batched(model, shard_batch(images, mesh), anchors, cfg, device)
        if not mesh.collective:
            return out
        fields = []
        with torch.inference_mode():
            for f in out:
                # gloo has no bool collectives: valid travels as uint8
                t = f.to(torch.uint8) if f.dtype == torch.bool else f.contiguous()
                parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
                dist.all_gather(parts, t)
                cat = torch.cat(parts)
                fields.append(cat.bool() if f.dtype == torch.bool else cat)
        return PairDetections(*fields)

    return detect

