"""Weights made from the seed, on the device, in a few large calls: the
same seed gives the same float32 tensors on any run. The benchmark hands
its own copies to the program (load_state_dict copies them) and to the
plain reference, so neither side reads the other's.

A family's `spec` (families/<family>.py) lists the tensors in torch's
names and layouts (OIHW conv kernels, (out, in) Dense kernels, (in, out,
kh, kw) transpose kernels), the module names of the configuration's
architecture; `make` draws them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the standard deviation of a unit normal truncated at +-2
TRUNC2_STD = 0.87962566103423978

# (name, shape, kind, fan) with kind one of "normal" (std = value),
# "trunc" (truncated at +-2 std, std = value), "const" (fill value),
# "uniform" ((lo, hi))
Spec = List[Tuple[str, Tuple[int, ...], str, object]]


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tensors of `spec` from `seed`: one normal and one uniform draw
    on `device` for all of them, sliced and scaled."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    n_normal = sum(n for n, (_, _, kind, _) in zip(sizes, spec) if kind in ("normal", "trunc"))
    n_unif = sum(n for n, (_, _, kind, _) in zip(sizes, spec) if kind == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(max(n_unif, 1), generator=g, device=device)
    out, i, j = {}, 0, 0
    for n, (name, shape, kind, v) in zip(sizes, spec):
        if kind == "const":
            t = torch.full(shape, float(v), device=device)
        elif kind == "uniform":
            lo, hi = v
            t = (lo + (hi - lo) * unif[j:j + n]).view(shape)
            j += n
        else:
            z = normal[i:i + n]
            if kind == "trunc":
                z = z.clamp(-2.0, 2.0) / TRUNC2_STD
            t = (z * float(v)).view(shape)
            i += n
        out[name] = t.contiguous()
    return out


def production_density(w: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The head of ConvNeXt with random weights, set so that the count path
    sees a production density of objects (the pattern of the root bench.py's
    production_density_variables): the objectness channel (4) of the
    transpose upsample takes only the objectness channel of the 1x1 conv,
    whose kernel row is scaled and whose bias is set."""
    pd = cfg["production_density"]
    up = w["format_up.weight"].clone()
    up[:, 4] = 0.0
    up[4, 4] = 1.0
    upb = w["format_up.bias"].clone()
    upb[4] = 0.0
    fw, fb = w["format_conv.weight"].clone(), w["format_conv.bias"].clone()
    fw[4] *= pd["obj_kernel_scale"]
    fb[4] = pd["obj_bias"]
    return {**w, "format_up.weight": up, "format_up.bias": upb,
            "format_conv.weight": fw, "format_conv.bias": fb}
