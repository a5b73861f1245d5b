"""Carry weights and optimizer state between the JAX package's flax / optax
layout and torch modules, both ways, as numpy trees.

flax keeps conv kernels HWIO and names BN tensors scale/bias/mean/var; the
port's ConvStack (models/yogo.py) keeps torch's OIHW and BatchNorm2d names:

  params/conv{i}/kernel (HWIO)   <-> conv{i}.weight (OIHW, transpose(3,2,0,1))
  params/conv{i}/bias            <-> conv{i}.bias
  params/bn{i}/{scale,bias}      <-> bn{i}.{weight,bias}
  batch_stats/bn{i}/{mean,var}   <-> bn{i}.running_{mean,var}
  (bn{i}.num_batches_tracked, which flax does not track, is 0 one way and
  dropped the other)

The optimizer of train.make_optimizer is, in the JAX package,
optax.chain(clip, adamw(schedule)), whose state flax serializes as

  {"0": {},                                  # clip
   "1": {"0": {"count", "mu", "nu"},        # scale_by_adam
         "1": {},                            # add_decayed_weights
         "2": {"count"}}}                    # scale_by_schedule

with mu / nu shaped like params. torch.optim.AdamW keeps, per parameter,
step / exp_avg / exp_avg_sq, and the scheduler its own step count.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# torch parameter suffix <-> flax leaf name, by module kind
_LEAVES = {"conv": {"weight": "kernel", "bias": "bias"}, "bn": {"weight": "scale", "bias": "bias"}}
_STATS = {"running_mean": "mean", "running_var": "var"}


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _kind(name: str) -> str:
    for kind in _LEAVES:
        if name.startswith(kind):
            return kind
    raise ValueError(f"unexpected parameter group {name!r} (not a conv stack?)")


def named_from_flax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params-shaped tree (the params, or Adam's mu / nu) ->
    {torch parameter name: float32 tensor}, conv kernels in OIHW."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        for suffix, leaf in _LEAVES[_kind(name)].items():
            if leaf not in leaves:
                continue
            t = _tensor(leaves[leaf])
            if leaf == "kernel":
                t = t.permute(3, 2, 0, 1).contiguous()
            out[f"{name}.{suffix}"] = t
    return out


def flax_params_from_named(named: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of named_from_flax_params: {torch parameter name: tensor
    or array} -> a flax params-shaped tree of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    for key, value in named.items():
        name, suffix = key.rsplit(".", 1)
        leaf = _LEAVES[_kind(name)][suffix]
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        a = np.asarray(a, np.float32)
        if leaf == "kernel":
            a = a.transpose(2, 3, 1, 0)
        params.setdefault(name, {})[leaf] = np.ascontiguousarray(a)
    return params


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables {"params": ..., "batch_stats": ...} of a conv stack ->
    a state_dict that ConvStack.load_state_dict(strict=True) accepts."""
    sd = named_from_flax_params(variables["params"])
    for name, stats in variables.get("batch_stats", {}).items():
        for buffer, leaf in _STATS.items():
            sd[f"{name}.{buffer}"] = _tensor(stats[leaf])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A ConvStack state_dict -> flax variables {"params", "batch_stats"}
    as nested dicts of float32 numpy arrays (what save_checkpoint writes
    and the JAX package's YOGO.apply takes)."""
    named, batch_stats = {}, {}
    for key, value in state_dict.items():
        name, suffix = key.rsplit(".", 1)
        if suffix in _STATS:
            batch_stats.setdefault(name, {})[_STATS[suffix]] = np.array(
                value.detach().cpu().numpy(), np.float32
            )
        elif suffix != "num_batches_tracked":
            named[key] = value
    return {"params": flax_params_from_named(named), "batch_stats": batch_stats}


# ------------------------------------------------------------ optimizer state
def optax_state_from_torch(
    stack: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> Dict[str, Any]:
    """The AdamW moments and step counts as the optax state tree of the JAX
    package's make_optimizer (see the module docstring). A parameter the
    optimizer has not stepped yet has zero moments."""
    mu, nu, count = {}, {}, 0
    for name, p in stack.named_parameters():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = max(count, int(st.get("step", 0)))
    adam = {
        "count": np.asarray(count, np.int32),
        "mu": flax_params_from_named(mu),
        "nu": flax_params_from_named(nu),
    }
    schedule = {"count": np.asarray(scheduler.last_epoch, np.int32)}
    return {"0": {}, "1": {"0": adam, "1": {}, "2": schedule}}


def load_optax_state(
    opt_state: Dict[str, Any],
    stack: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> None:
    """Load an optax state tree of make_optimizer (as optax_state_from_torch
    writes it, or decoded from a checkpoint's opt_state bytes) into the
    AdamW and its scheduler: the next step continues where JAX would."""
    adam = opt_state["1"]["0"]
    mu = named_from_flax_params(adam["mu"])
    nu = named_from_flax_params(adam["nu"])
    names = [name for name, _ in stack.named_parameters()]
    if sorted(names) != sorted(mu) or sorted(names) != sorted(nu):
        raise ValueError(
            f"optimizer state has parameters {sorted(mu)}, the model has {sorted(names)}"
        )
    index = {p: i for g in optimizer.param_groups for i, p in enumerate(g["params"])}
    if len(optimizer.param_groups) != 1 or len(index) != len(names):
        raise ValueError("expected one parameter group holding every parameter of the stack")
    step = float(np.asarray(adam["count"]))
    state = {}
    for name, p in stack.named_parameters():
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: moment shape {tuple(mu[name].shape)} vs {tuple(p.shape)}")
        state[index[p]] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name],
            "exp_avg_sq": nu[name],
        }
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
    )
    set_schedule_step(scheduler, int(np.asarray(opt_state["1"]["2"]["count"])))


def set_schedule_step(scheduler: torch.optim.lr_scheduler.LambdaLR, count: int) -> None:
    """Put a LambdaLR at optimizer step `count`: the next optimizer.step()
    uses the learning rate of that step."""
    scheduler.last_epoch = count
    scheduler._step_count = count + 1
    lrs = [base * fn(count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
