"""Data parallelism over rays with ``torch.distributed``.

Counterpart of ``vdnerf_tpu/parallel/mesh.py``. The work is embarrassingly
parallel over rays, so the strategy is 1-D data parallelism over the cards of
one node, one process per card (``torchrun --standalone --nproc_per_node=N``):

- every rank draws the same full ray batch from the same seeded host stream
  and keeps a contiguous block of it (:func:`shard_batch`: the JAX package's
  ``P('data')`` for the per-ray leaves, ``P()`` for ``img_idx``);
- parameters are replicated: broadcast from rank 0 at the start of a run and
  after a resume (:func:`broadcast_parameters`), then kept equal by equal
  updates;
- the loss normalisers are global sums (:meth:`World.sum`, at the step's
  sums, JAX's ``psum``), so the sharded loss is the single-process one;
- the gradients are summed once per step, after the ``grad_accum``
  microbatches (:func:`all_reduce_grads`), in one collective;
- each rank has its own jitter stream (:func:`rank_seed`, JAX's
  ``fold_in(axis_index)``): statistically, not bitwise, the single-process
  run.

A :class:`World` decides whether a trainer communicates (``grouped``), so
a trainer given ``World()`` computes alone in any process. On the card the
collectives are NCCL's and run inside the captured step
(``train/dispatch.py``); on the CPU (the tests) gloo's. A gloo group beside
NCCL carries what only the host needs (:class:`World`: barriers, the
preemption flag, the closing summary), so that no host decision waits on the
card's stream.

Gradients. :func:`global_sum` passes the gradient to the local term alone,
so after :func:`all_reduce_grads` each gradient is the single-process one.
The JAX sharded step differentiates through ``psum``, which ``shard_map``
(``check_vma=False``) transposes to a second ``psum``: its summed gradient is
N times the single-device one, which Adam's update hides up to ``eps``. The
port does not copy that factor; its tests hold the JAX gradient divided by N.

Multi-node training is out of scope: the JAX package's mesh is one host's
devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# the variables torchrun sets for each rank
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the training ranks. ``grouped``: the ranks
    communicate over the default process group (under torchrun, also at size
    1); ``host_group``: the gloo group for host-side agreement (None: the
    default group, gloo itself)."""

    rank: int = 0
    size: int = 1
    grouped: bool = False
    host_group: object = None

    @property
    def lead(self) -> bool:
        """Rank 0: the rank that writes files."""
        return self.rank == 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`global_sum` under a group, ``x`` itself without one."""
        return global_sum(x) if self.grouped else x

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier(group=self.host_group)

    def any(self, flag: bool) -> bool:
        """``flag`` on any rank (a MAX all-reduce on the host)."""
        if not self.grouped:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self.grouped:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]


def active() -> bool:
    """A default process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def env_world_size() -> int | None:
    """``WORLD_SIZE`` as torchrun sets it; None outside torchrun."""
    size = os.environ.get("WORLD_SIZE")
    return None if size is None else int(size)


def init_from_env(device: torch.device) -> World:
    """The world torchrun describes, its default group made if none exists:
    NCCL on ``cuda:<LOCAL_RANK>`` (the current device from then on) for a
    CUDA ``device``, gloo for the CPU. ``World()`` (size 1, no group) when
    the variables are absent."""
    if env_world_size() is None:
        return World()
    missing = [k for k in RANK_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: start with torchrun")
    rank, size, local = (int(os.environ[k]) for k in RANK_ENV)
    if not active():
        if device.type == "cuda":
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", rank=rank, world_size=size,
                                    device_id=torch.device("cuda", local))
        else:
            dist.init_process_group("gloo", rank=rank, world_size=size)
    host = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else None
    return World(rank, size, True, host)


@contextlib.contextmanager
def world_from_env(device: torch.device):
    """:func:`init_from_env` for the length of the block; on exit destroys
    the groups it made (the default group only if it made it)."""
    made = env_world_size() is not None and not active()
    world = init_from_env(device)
    try:
        yield world
    finally:
        if made:
            dist.destroy_process_group()
        elif world.host_group is not None:
            dist.destroy_process_group(world.host_group)


def rank_seed(seed: int, rank: int) -> int:
    """The training generator's seed on ``rank``: ``seed`` itself on rank 0
    (so a world of 1 is the single-process run bit for bit), one drawn from
    ``SeedSequence([seed, rank])`` on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])


def shard_batch(batch: dict, world: World, grad_accum: int = 1) -> dict:
    """Rank r's block of one step's pixel batch: rows ``[r B/N, (r+1) B/N)``
    of every per-ray leaf, ``img_idx`` whole (a window's batches are cut one
    by one, before they are stacked). Raises unless N divides the batch and
    ``grad_accum`` divides the block."""
    n = batch["pixels_x"].shape[0]
    if n % world.size:
        raise ValueError(f"a batch of {n} rays does not split over {world.size} ranks")
    m = n // world.size
    if m % max(grad_accum, 1):
        raise ValueError(f"a block of {m} rays does not split into {grad_accum} microbatches")
    if world.size == 1:
        return batch
    block = slice(world.rank * m, (world.rank + 1) * m)
    return {k: v if k == "img_idx" else v[block] for k, v in batch.items()}


class _GlobalSum(torch.autograd.Function):
    """The all-reduced sum forward; the cotangent to the local term alone
    backward (a differentiable all-reduce would sum the cotangents again, and
    the gradients would come out N times too large once they are summed)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the default group; its gradient flows
    to this rank's ``x`` only."""
    return _GlobalSum.apply(x)


def all_reduce_grads(params) -> None:
    """Sum every ``p.grad`` over the ranks in place: packed into one flat f32
    buffer, one SUM all-reduce, unpacked."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_parameters(*modules: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers of ``modules`` on every rank, in place."""
    for module in modules:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t, src=0)
