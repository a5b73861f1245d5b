"""Carry weights from the JAX package's flax layout to torch modules.

flax keeps conv kernels HWIO and names BN tensors scale/bias/mean/var; the
port's ConvStack (models/yogo.py) keeps torch's OIHW and BatchNorm2d names:

  params/conv{i}/kernel (HWIO)   -> conv{i}.weight (OIHW, transpose(3,2,0,1))
  params/conv{i}/bias            -> conv{i}.bias
  params/bn{i}/{scale,bias}      -> bn{i}.{weight,bias}
  batch_stats/bn{i}/{mean,var}   -> bn{i}.running_{mean,var}
  (and bn{i}.num_batches_tracked = 0, which flax does not track)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables {"params": ..., "batch_stats": ...} of a conv stack ->
    a state_dict that ConvStack.load_state_dict(strict=True) accepts."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in variables["params"].items():
        if name.startswith("conv"):
            sd[f"{name}.weight"] = _tensor(leaves["kernel"]).permute(3, 2, 0, 1).contiguous()
            if "bias" in leaves:
                sd[f"{name}.bias"] = _tensor(leaves["bias"])
        elif name.startswith("bn"):
            stats = variables["batch_stats"][name]
            sd[f"{name}.weight"] = _tensor(leaves["scale"])
            sd[f"{name}.bias"] = _tensor(leaves["bias"])
            sd[f"{name}.running_mean"] = _tensor(stats["mean"])
            sd[f"{name}.running_var"] = _tensor(stats["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:
            raise ValueError(f"unexpected parameter group {name!r} (not a conv stack?)")
    return sd
