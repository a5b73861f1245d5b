"""Process-group set-up and the few collectives the port runs (port of
yogo_tpu/parallel/distributed.py).

JAX is single-controller: one process drives every local chip and only a
multi-host pod needs jax.distributed.initialize(). torch is one process a
device, as the reference's DDP (reference: yogo/train.py:96-105, 152-159):
`torchrun --nproc-per-node N -m yogo_tpu_torch ...` starts N processes and
each calls `initialize_multihost()`. The backend is NCCL for CUDA ranks and
gloo for CPU ranks (the tests' worker processes); gloo also carries CUDA
tensors, staged through the host, which is how two ranks share one card
(NCCL refuses two ranks on one device).

Every helper below is the identity at world 1, so a one-process run is the
single-device program, bit for bit, with or without a group.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

DEFAULT_TIMEOUT_S = 600.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def _env_address() -> Optional[str]:
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return os.environ.get("JAX_COORDINATOR_ADDRESS")


def local_device(device_arg=None, n_space: int = 1) -> torch.device:
    """The device of this rank: `device_arg` when the caller names one
    ("cpu", or a card), else cuda:LOCAL_RANK * n_space (the first of the
    rank's n_space row-shard cards, parallel/mesh.device_grid), made
    current. Without a card and without an explicit device it raises: a
    rank never drops to the CPU on its own."""
    if device_arg is not None:
        dev = torch.device(device_arg)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", (_env_int("LOCAL_RANK") or 0) * n_space)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
            )
        dev = torch.device("cuda", (_env_int("LOCAL_RANK") or 0) * n_space)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def collective_device(device: torch.device) -> torch.device:
    """Where this rank's collectives on a tensor of `device` run: under
    NCCL the card the group is bound to (the rank's first card; a rank of
    a row-split run holds other cards too), else `device`."""
    if device.type == "cuda" and dist.is_available() and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        bound = getattr(dist.distributed_c10d._get_default_group(), "bound_device_id", None)
        return bound if bound is not None else torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device=None,
    n_space: int = 1,
) -> bool:
    """Join the process group of a multi-process run.

    The arguments default to torchrun's environment (MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE, RANK), then to the JAX package's (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID), so a launch script of either package
    works. One process (or no world size at all) creates no group and
    returns False; otherwise the group is created with an explicit timeout
    and True is returned. `device` is this rank's device as the caller
    names it (None: the card, as every entry point; with n_space row
    shards a rank, the first of its n_space cards). backend=None picks
    NCCL for a card and gloo for the CPU; pass "gloo" to run ranks that
    share one card. The JAX package's TPU_WORKER_HOSTNAMES autodetect has
    no counterpart here."""
    address = coordinator_address or _env_address()
    world = num_processes or _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int("RANK", "JAX_PROCESS_ID")
    if world is None or world <= 1:
        return False
    if address is None or rank is None:
        raise ValueError(
            f"a run of {world} processes needs a coordinator address and this "
            "process's rank (MASTER_ADDR / MASTER_PORT and RANK under torchrun)"
        )
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    on_card = torch.device(device or "cuda").type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{address}",
        world_size=int(world),
        rank=int(rank),
        timeout=timedelta(seconds=timeout_s),
        # NCCL binds the group to this rank's card
        device_id=local_device(device, n_space) if backend == "nccl" else None,
    )
    return True


def process_shard() -> Tuple[int, int]:
    """(rank, world size) for sharding host-side data loaders; (0, 1)
    without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return process_shard()[1]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks, in place (the identity at world 1)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the sum of the gradients over
    the ranks: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable across them (what
    torch.distributed.nn.functional.all_reduce computes, without its
    deprecation); `t` at world 1."""
    return _AllReduceSum.apply(t) if world_size() > 1 else t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum the gradients of `params` over the ranks in one bucket: one
    all_reduce of their concatenation. Parameters without a gradient and
    FSDP-managed ones (DTensor, reduce-scattered by FSDP) are left alone."""
    if world_size() == 1:
        return
    grads = [
        p.grad for p in params
        if p.grad is not None and not isinstance(p.grad, DTensor)
    ]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset: offset + n].view_as(g))
        offset += n


def broadcast_from_rank0(t: torch.Tensor) -> torch.Tensor:
    if world_size() > 1:
        dist.broadcast(t, 0)
    return t


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
