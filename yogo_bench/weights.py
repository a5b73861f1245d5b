"""Weights made from the seed, on the device, in a few large calls: the
same seed gives the same float32 tensors on any run. The benchmark hands
its own copies to the program (load_state_dict copies them) and to the
plain reference, so neither side reads the other's.

The names and layouts are torch's (OIHW conv kernels, (out, in) Dense
kernels, (in, out, kh, kw) transpose kernels), the module names of the
configuration's architecture.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LEAKY_SLOPE = 0.01
# the standard deviation of a unit normal truncated at +-2
TRUNC2_STD = 0.87962566103423978

# (name, shape, kind, fan) with kind one of "normal" (std = value),
# "trunc" (truncated at +-2 std, std = value), "const" (fill value),
# "uniform" ((lo, hi))
Spec = List[Tuple[str, Tuple[int, ...], str, object]]


def conv_stack_spec(cfg: dict) -> Spec:
    """A conv stack's initial state, as the reference yogo/model.py:79-87
    inits it: conv kernels Kaiming-normal in fan-out mode with the
    LeakyReLU(0.01) gain, zero biases, BN scale 1 and bias 0, running mean
    0 and variance 1."""
    spec: Spec = []
    cin = 1
    gain = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
    for i, b in enumerate(cfg["blocks"]):
        k, cout = b["kernel"], b["out"]
        spec.append((f"conv{i}.weight", (cout, cin, k, k), "normal", gain / math.sqrt(cout * k * k)))
        if b["bias"]:
            spec.append((f"conv{i}.bias", (cout,), "const", 0.0))
        if b["bn"]:
            spec += [(f"bn{i}.weight", (cout,), "const", 1.0), (f"bn{i}.bias", (cout,), "const", 0.0),
                     (f"bn{i}.running_mean", (cout,), "const", 0.0),
                     (f"bn{i}.running_var", (cout,), "const", 1.0)]
        cin = cout
    return spec


def convnext_spec(cfg: dict) -> Spec:
    """ConvNeXt-Small's weights as the configuration file states them
    (`init`): truncated-normal kernels of variance 1 / fan-in (flax's
    lecun_normal), biases normal with std init.bias_std, LayerNorms 1 / 0,
    the layer scale `gamma` uniform in init.layer_scale, and the head's
    objectness set for production density (production_density)."""
    init = cfg["init"]
    dims, depths, k_dw, ratio = cfg["dims"], cfg["depths"], cfg["dw_kernel"], cfg["mlp_ratio"]
    nout, patch = 5 + cfg["num_classes"], cfg["patch"]
    bstd = init["bias_std"]
    spec: Spec = []

    def conv(name, cout, cin, k, groups=1):
        fan_in = cin // groups * k * k
        spec.append((f"{name}.weight", (cout, cin // groups, k, k), "trunc", 1.0 / math.sqrt(fan_in)))
        spec.append((f"{name}.bias", (cout,), "normal", bstd))

    def norm(name, d):
        spec.extend([(f"{name}.weight", (d,), "const", 1.0), (f"{name}.bias", (d,), "const", 0.0)])

    conv("stem_conv", dims[0], 1, patch)
    norm("stem_norm", dims[0])
    for s, (depth, d) in enumerate(zip(depths, dims)):
        if s > 0:
            norm(f"down{s}_norm", dims[s - 1])
            conv(f"down{s}_conv", d, dims[s - 1], 2)
        for b in range(depth):
            p = f"stage{s}_block{b}"
            conv(f"{p}.dwconv", d, d, k_dw, groups=d)
            norm(f"{p}.norm", d)
            spec.append((f"{p}.pwconv1.weight", (ratio * d, d), "trunc", 1.0 / math.sqrt(d)))
            spec.append((f"{p}.pwconv1.bias", (ratio * d,), "normal", bstd))
            spec.append((f"{p}.pwconv2.weight", (d, ratio * d), "trunc", 1.0 / math.sqrt(ratio * d)))
            spec.append((f"{p}.pwconv2.bias", (d,), "normal", bstd))
            spec.append((f"{p}.gamma", (d,), "uniform", tuple(init["layer_scale"])))
    conv("format_conv", nout, dims[-1], 1)
    spec.append(("format_up.weight", (nout, nout, 4, 4), "trunc", 1.0 / math.sqrt(nout * 16)))
    spec.append(("format_up.bias", (nout,), "normal", bstd))
    return spec


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
