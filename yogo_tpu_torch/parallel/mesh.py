"""Batch and state placement for multi-process data parallelism (port of
yogo_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a mesh: parameters replicated
(or sharded, under --fsdp), the batch sharded on the "data" axis, and XLA
inserts the collectives. Here each rank is a process holding its own rows,
and the collectives are explicit. What took the place of each JAX helper:

  - get_mesh / data_sharded / shard_batch / replicate_to_mesh: nothing; a
    rank holds its loader shard (data/loader.py `shard=(rank, world)`) and
    a full copy of the state, made equal on every rank by one seed or one
    checkpoint;
  - the gradient all-reduce XLA inserts into the sharded step: one bucketed
    all_reduce SUM of the gradients after backward
    (distributed.all_reduce_grads), with each rank's loss divided by the
    GLOBAL real-image count (train.make_train_step), so the sum is the
    global batch's gradient whatever the padding; no DistributedDataParallel,
    whose average is that only when every rank has as many real images;
  - BatchNorm's statistics over the sharded batch: one autograd-aware
    all_reduce of the per-channel sums (models/yogo.py `_batch_norm`);
  - fsdp_sharding_tree / put_with_shardings / fetch_replicated: FSDP2's
    fully_shard over a 1-D device mesh with the same size rule
    (`fully_shard_stack`), and `full_state_dict` to gather it back;
  - fetch_local_rows: a rank's output already is its own rows;
    `gather_rows` is its inverse, the all_gather of every rank's rows;
  - local_rows: the same slice of a global-batch array;
  - get_mesh_2d's device selection (yogo_tpu/infer.py:251-278,
    yogo_tpu/serve.py:451-475): `device_grid`, a list of data groups of
    n_space devices each, which `infer` and `serve` build their
    row-split Predictors on (parallel/spatial.py); replicate_to_mesh of
    the weights and the int8 program: `replicate`.

The pad helpers are the JAX package's: padded rows are copies of row 0 with
mask 0, and they enter the BatchNorm statistics as they do in JAX.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from yogo_tpu_torch.parallel.distributed import process_shard, world_size

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the JAX package's fsdp_sharding_tree min_size: smaller leaves (BN vectors,
# biases) stay replicated - scattering them saves nothing and costs a collective
FSDP_MIN_SIZE = 4096


def pad_batch_to_size(
    imgs: np.ndarray, labels: np.ndarray, mask: np.ndarray, target: int
) -> Batch:
    """Pad the batch axis to exactly `target` rows; padded rows masked out."""
    b = imgs.shape[0]
    if target == b:
        return imgs, labels, mask
    pad = target - b
    imgs = np.concatenate([imgs, np.repeat(imgs[:1], pad, axis=0)])
    labels = np.concatenate([labels, np.repeat(labels[:1], pad, axis=0)])
    mask = np.concatenate([mask, np.zeros(pad, mask.dtype)])
    return imgs, labels, mask


def pad_batch_to_multiple(
    imgs: np.ndarray, labels: np.ndarray, mask: np.ndarray, multiple: int
) -> Batch:
    """Pad the batch axis so `multiple` divides it; padded rows masked out."""
    target = -(-imgs.shape[0] // multiple) * multiple
    return pad_batch_to_size(imgs, labels, mask, target)


def n_data() -> int:
    """The number of batch shards: the world size (1 without a group)."""
    return world_size()


def validate_spatial_height(n_space: int, img_h: int) -> None:
    """The input height must divide over the spatial factor (772 allows 2
    or 4), as the JAX package requires of its sharded input."""
    if img_h % n_space:
        raise ValueError(
            f"image height {img_h} is not divisible by the spatial axis "
            f"size {n_space}; pick a spatial factor that divides the height "
            f"(772 allows 2 or 4) or crop to a divisible height"
        )


def as_device(d) -> torch.device:
    """d as a torch.device; a card named without an index is the current one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def device_grid(
    n_space: int = 1,
    data_parallel: bool = False,
    *,
    devices: Optional[Sequence] = None,
    device=None,
) -> List[List[torch.device]]:
    """The devices of a run as data groups of `n_space` row shards each
    (the port of get_mesh_2d's selection): a list of groups, each a list
    of n_space devices.

      - `devices` given: that list, its first n_space entries unless
        data_parallel (tests and chip_smoke.py map N shards onto one card
        with ["cuda:0"] * N);
      - `device` a non-CUDA device ("cpu"): n_space handles to it, one
        group;
      - else the cards: under a process group each rank takes its own
        n_space cards, cuda:LOCAL_RANK*n_space onwards (the JAX package's
        per-process device count that n_space divides), one group a rank;
        in one process spatial-only takes exactly n_space cards (from
        `device`'s index), and data_parallel every visible card.
    n_space must divide the device count. Too few cards raise, naming the
    count; nothing falls back to fewer devices or to the CPU."""
    if n_space < 1:
        raise ValueError(f"spatial_parallel must be >= 1, got {n_space}")
    if devices is not None:
        devs = [as_device(d) for d in devices]
        if not data_parallel:
            if len(devs) < n_space:
                raise ValueError(f"spatial_parallel={n_space} needs {n_space} devices, got {len(devs)}")
            devs = devs[:n_space]
    elif device is not None and torch.device(device).type != "cuda":
        devs = [torch.device(device)] * n_space
    else:
        devs = _cards(n_space, data_parallel, device)
    if not devs or len(devs) % n_space:
        raise ValueError(
            f"spatial axis size {n_space} must divide the device count {len(devs)}"
        )
    return [devs[g: g + n_space] for g in range(0, len(devs), n_space)]


def _cards(n_space: int, data_parallel: bool, device) -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    count = torch.cuda.device_count()
    world = world_size()
    if world > 1:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if count < local_world * n_space:
            raise ValueError(
                f"{local_world} ranks on this node with spatial_parallel={n_space} "
                f"need {local_world * n_space} cards; {count} are visible"
            )
        first = int(os.environ.get("LOCAL_RANK", 0)) * n_space
    elif data_parallel:
        return [torch.device("cuda", i) for i in range(count)]
    else:
        first = (torch.device(device).index or 0) if device is not None else 0
        if count < first + n_space:
            raise ValueError(
                f"spatial_parallel={n_space} from cuda:{first} needs {first + n_space} "
                f"cards; {count} are visible"
            )
    return [torch.device("cuda", first + i) for i in range(n_space)]


def replicate(stack: nn.Module, qp: Optional[Dict[str, Any]], device: torch.device):
    """(stack, int8 program) on `device`: the same objects where they
    already are there, else copies (replicate_to_mesh of one device)."""
    if next(stack.parameters()).device == device:
        return stack, qp
    return copy.deepcopy(stack).to(device), _tree_to(qp, device)


def _tree_to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree


def local_rows(global_np: np.ndarray, local_batch: int) -> np.ndarray:
    """This rank's rows of a global-batch array whose rank p holds rows
    [p*local_batch, (p+1)*local_batch); the array unchanged at world 1."""
    rank, world = process_shard()
    if world == 1:
        return global_np
    start = rank * local_batch
    return global_np[start: start + local_batch]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows (equal row counts): an
    all_gather, rank order along axis 0. `t` itself at world 1."""
    world = world_size()
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


# ------------------------------------------------------------------ FSDP
def fsdp_sharded(p: torch.Tensor, world: int, min_size: int = FSDP_MIN_SIZE) -> bool:
    """The JAX package's rule: shard a leaf over the ranks when it holds at
    least `min_size` elements and its output-channel axis divides by the
    world size (the last axis of a flax HWIO kernel or Dense (in, out)
    matrix is dim 0 of torch's OIHW / (out, in) tensor)."""
    return world > 1 and p.dim() >= 1 and p.numel() >= min_size and p.shape[0] % world == 0


def fully_shard_stack(stack: nn.Module, min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """Shard the module's large parameters over the ranks with FSDP2
    (dim 0, so their AdamW moments shard with them); the small ones stay
    replicated plain tensors whose gradients the train step sums itself.
    FSDP's reduce-scatter sums instead of averaging, as the step's loss is
    already divided by the global image count. Buffers (BN statistics)
    stay replicated; global BatchNorm keeps them equal on every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    world = world_size()
    if world == 1:
        return stack
    device = next(stack.parameters()).device
    mesh = init_device_mesh(device.type, (world,))
    # FSDP shards contiguous tensors only (a channels_last stack's kernels
    # are not); the gathered kernels are contiguous in any case
    for p in stack.parameters():
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    replicated = {p for p in stack.parameters() if not fsdp_sharded(p, world, min_size)}
    fully_shard(stack, mesh=mesh, ignored_params=replicated)
    stack.set_gradient_divide_factor(1.0)
    # a plain SUM reduce-scatter: gloo has no PREMUL_SUM
    stack.set_force_sum_reduction_for_comms(True)
    return stack


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A dim-0-sharded tensor (fully_shard_stack's) gathered whole by one
    all_gather on the process group, or `t` as it is; a collective every
    rank joins. (DTensor.full_tensor goes through the functional
    collectives, which crash in gloo on CUDA tensors.)"""
    if not isinstance(t, DTensor):
        return t
    world = t.device_mesh.size()
    local = t.to_local()
    rows = -(-t.shape[0] // world)  # torch.chunk's shard size; the last may be short
    buf = local.new_zeros((rows, *local.shape[1:]))
    buf[: local.shape[0]] = local
    out = local.new_empty((rows * world, *local.shape[1:]))
    dist.all_gather_into_tensor(out, buf, group=t.device_mesh.get_group())
    return out[: t.shape[0]]


def shard_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's dim-0 shard of a whole tensor that every rank holds (a
    checkpoint's), placed as `like`; no communication."""
    mesh = like.device_mesh
    chunk = torch.chunk(full, mesh.size(), dim=0)[mesh.get_local_rank()]
    return DTensor.from_local(chunk.to(like.device).contiguous(), mesh, like.placements,
                              run_check=False, shape=like.shape, stride=like.stride())


def full_state_dict(stack: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict with every sharded tensor gathered whole;
    under FSDP every rank must call it together, as the JAX package's
    fetch_replicated."""
    return {k: full_tensor(v).detach() for k, v in stack.state_dict().items()}
