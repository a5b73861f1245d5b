"""Tiny ONNX interpreter for the YOGO export op set (port of
yogo_tpu/utils/onnx_interp.py).

Executes graphs produced by yogo_tpu_torch.utils.export_model so export
parity can be asserted without onnxruntime (the reference gates exports on
an onnxruntime allclose at rtol 1e-3 / atol 1e-5, reference:
yogo/utils/export_model.py:127-133 - the same gate, interpreted here).
Conv, ConvTranspose and MatMul run through torch in float32 on the
caller's device, inside models.yogo.no_tf32: cuDNN's and cuBLAS's TF32
rounding alone exceeds the gate's atol (a ConvNeXt head on the card moves
1.49e-3 with TF32 on). Every other op is the JAX package's numpy, line for
line. Ops: Conv, ConvTranspose, LeakyRelu, Sigmoid, Softmax, Exp, Clip,
Mul, Add, Div, Sub, Cast, Concat, Slice, Constant, Identity, Reciprocal,
Gather, Unsqueeze, Squeeze, Shape, Reshape, Split, BatchNormalization,
MatMul, Tanh, Erf, Pow, LayerNormalization, Transpose.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from yogo_tpu_torch.models.yogo import no_tf32, resolve_device
from yogo_tpu_torch.utils.onnx_proto import ONNX_TO_NP, parse_model


def _f32(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:  # an initializer, a view of the model bytes
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _bias(out: torch.Tensor, b, device: torch.device) -> torch.Tensor:
    return out if b is None else out + _f32(b, device)[None, :, None, None]


def _conv(x, w, b, strides, pads, group, device):
    """NCHW conv; ONNX pads are (top, left, bottom, right)."""
    x = _f32(x, device)
    if (pads[0], pads[1]) != (pads[2], pads[3]):
        x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
        pads = [0, 0, 0, 0]
    with no_tf32(device), torch.inference_mode():
        out = F.conv2d(x, _f32(w, device), None, strides, (pads[0], pads[1]),
                       groups=group)
        return _bias(out, b, device).cpu().numpy()


def _conv_transpose(x, w, b, strides, pads, device):
    # ONNX ConvTranspose weight layout is (C_in, C_out/group, kH, kW) -
    # torch's conv_transpose2d layout too (flax's HWIO kernel, unflipped,
    # is neither: export_model flips and transposes it); ONNX semantics:
    # full "VALID" transposed conv, then crop `pads` from each spatial edge
    with no_tf32(device), torch.inference_mode():
        out = F.conv_transpose2d(_f32(x, device), _f32(w, device), None, strides)
        h, wd = out.shape[2], out.shape[3]
        out = out[:, :, pads[0] : h - pads[2], pads[1] : wd - pads[3]]
        return _bias(out, b, device).cpu().numpy()


def _matmul(a, b, device):
    with no_tf32(device), torch.inference_mode():
        return torch.matmul(_f32(a, device), _f32(b, device)).cpu().numpy()


def run_model(model_bytes: bytes, feeds: Dict[str, np.ndarray], device=None):
    """Execute an ONNX graph on numpy feeds -> the graph outputs as numpy
    arrays. Conv, ConvTranspose and MatMul run through torch on `device`
    (default CUDA; an error without one) in float32 with TF32 off; every
    other op is numpy on the host."""
    device = resolve_device(device)
    m = parse_model(model_bytes)
    env: Dict[str, np.ndarray] = dict(m["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})

    for n in m["nodes"]:
        op = n["op_type"]
        ins = [env[i] if i else None for i in n["inputs"]]
        a = n["attrs"]
        if op == "Conv":
            strides = tuple(a.get("strides", [1, 1]))
            pads = a.get("pads", [0, 0, 0, 0])
            out = _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                        strides, pads, a.get("group", 1), device)
        elif op == "ConvTranspose":
            strides = tuple(a.get("strides", [1, 1]))
            pads = a.get("pads", [0, 0, 0, 0])
            out = _conv_transpose(ins[0], ins[1],
                                  ins[2] if len(ins) > 2 else None,
                                  strides, pads, device)
        elif op == "LeakyRelu":
            alpha = np.float32(a.get("alpha", 0.01))
            x = ins[0].astype(np.float32)
            out = np.where(x >= 0, x, alpha * x)
        elif op == "Sigmoid":
            with np.errstate(over="ignore"):
                out = np.float32(1.0) / (
                    np.float32(1.0) + np.exp(-ins[0].astype(np.float32))
                )
        elif op == "Softmax":
            axis = a.get("axis", -1)
            x = ins[0].astype(np.float32)
            x = x - x.max(axis=axis, keepdims=True)
            e = np.exp(x)
            out = e / e.sum(axis=axis, keepdims=True)
        elif op == "Exp":
            out = np.exp(ins[0].astype(np.float32))
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else -np.inf
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else np.inf
            out = np.clip(ins[0], lo, hi)
        elif op == "Mul":
            out = ins[0].astype(np.float32) * ins[1].astype(np.float32)
        elif op == "Add":
            out = ins[0].astype(np.float32) + ins[1].astype(np.float32)
        elif op == "Sub":
            out = ins[0].astype(np.float32) - ins[1].astype(np.float32)
        elif op == "Div":
            out = ins[0].astype(np.float32) / ins[1].astype(np.float32)
        elif op == "Cast":
            out = ins[0].astype(ONNX_TO_NP[a["to"]])
        elif op == "Transpose":
            out = np.transpose(ins[0], a["perm"])
        elif op == "MatMul":
            out = _matmul(ins[0], ins[1], device)
        elif op == "Tanh":
            out = np.tanh(ins[0].astype(np.float32))
        elif op == "Erf":
            try:
                from scipy.special import erf  # vectorized C
            except ImportError:  # pragma: no cover - scipy ships with repo
                import math

                erf = np.vectorize(math.erf, otypes=[np.float32])
            out = erf(ins[0].astype(np.float32)).astype(np.float32)
        elif op == "Pow":
            out = ins[0].astype(np.float32) ** ins[1].astype(np.float32)
        elif op == "LayerNormalization":
            axis = a.get("axis", -1)
            eps = np.float32(a.get("epsilon", 1e-5))
            x = ins[0].astype(np.float32)
            mean = x.mean(axis=axis, keepdims=True)
            var = ((x - mean) ** 2).mean(axis=axis, keepdims=True)
            out = (x - mean) / np.sqrt(var + eps)
            out = out * ins[1]
            if len(ins) > 2 and ins[2] is not None:
                out = out + ins[2]
        elif op == "Concat":
            out = np.concatenate(ins, axis=a["axis"])
        elif op == "Slice":
            # axes and steps are OPTIONAL inputs (opset >= 10): independent
            # producers (torch, onnxsim) emit 3-input Slices after folding,
            # and absent optionals may also arrive as "" -> None
            starts, ends = ins[1], ins[2]
            axes = (
                ins[3]
                if len(ins) > 3 and ins[3] is not None
                else np.arange(len(starts), dtype=np.int64)
            )
            steps = (
                ins[4]
                if len(ins) > 4 and ins[4] is not None
                else np.ones_like(starts)
            )
            sl = [slice(None)] * ins[0].ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                sl[int(ax)] = slice(int(s), None if e >= 2**31 else int(e), int(st))
            out = ins[0][tuple(sl)]
        elif op == "Constant":
            out = a["value"]
        elif op == "Identity":
            out = ins[0]
        elif op == "Reciprocal":
            out = np.float32(1.0) / ins[0].astype(np.float32)
        elif op == "Gather":
            out = np.take(ins[0], ins[1].astype(np.int64), axis=a.get("axis", 0))
        elif op == "Unsqueeze":
            axes = ins[1] if len(ins) > 1 and ins[1] is not None else a["axes"]
            out = ins[0]
            for ax in sorted(int(x) for x in np.atleast_1d(axes)):
                out = np.expand_dims(out, ax)
        elif op == "Squeeze":
            axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
            out = (
                np.squeeze(ins[0])
                if axes is None
                else np.squeeze(ins[0], tuple(int(x) for x in np.atleast_1d(axes)))
            )
        elif op == "Shape":
            out = np.asarray(ins[0].shape, np.int64)
        elif op == "Reshape":
            # ONNX: a 0 entry copies the corresponding input dim
            # (allowzero=0 default, the form torch exporters emit)
            shape = [int(x) for x in ins[1]]
            if not a.get("allowzero", 0):
                shape = [
                    ins[0].shape[i] if s == 0 else s
                    for i, s in enumerate(shape)
                ]
            out = ins[0].reshape(tuple(shape))
        elif op == "Split":
            axis = a.get("axis", 0)
            if len(ins) > 1 and ins[1] is not None:
                sizes = [int(x) for x in ins[1]]
            elif "split" in a:
                sizes = [int(x) for x in a["split"]]
            else:
                # opset-18 equal-split: ceil-sized chunks, last one smaller
                # when the axis is not evenly divisible
                k = len(n["outputs"])
                n_ax = ins[0].shape[axis]
                chunk = -(-n_ax // k)
                sizes = [chunk] * (k - 1) + [n_ax - chunk * (k - 1)]
            offs = np.cumsum([0] + sizes)
            for oi, oname in enumerate(n["outputs"]):
                sl = [slice(None)] * ins[0].ndim
                sl[axis] = slice(int(offs[oi]), int(offs[oi + 1]))
                env[oname] = np.asarray(ins[0][tuple(sl)])
            continue
        elif op == "BatchNormalization":
            x = ins[0].astype(np.float32)
            scale, bias, mean, var = (v.astype(np.float32) for v in ins[1:5])
            eps = np.float32(a.get("epsilon", 1e-5))
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = (x - mean.reshape(shape)) / np.sqrt(
                var.reshape(shape) + eps
            ) * scale.reshape(shape) + bias.reshape(shape)
        else:  # pragma: no cover
            raise NotImplementedError(f"op {op} not supported by interpreter")
        env[n["outputs"][0]] = np.asarray(out)

    return [env[o] for o in m["outputs"]]
