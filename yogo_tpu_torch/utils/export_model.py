"""Model export: ONNX (dependency-free writer) and .pth (port of
yogo_tpu/utils/export_model.py).

Reference behavior (reference: yogo/utils/export_model.py:33-153): export a
wrapped model that takes raw uint8 input and bakes x/255 normalization into
the graph, verify the export matches the source model at rtol 1e-3/atol 1e-5,
then optionally convert to OpenVINO IR. Here, as in the JAX package:

  - ONNX: the graph is emitted directly (opset 17) with BatchNorm folded
    into conv weights at export time; normalization is baked in exactly
    like the reference's YOGOWrap. The graph is a function of the
    flax-layout variables alone (numpy), so it is the JAX package's
    `build_onnx` bytes for the same variables. Parity is asserted against
    the port's float32 forward by the built-in interpreter
    (utils/onnx_interp), both on the caller's device with TF32 off.
  - .pth: the reference's checkpoint format (utils/torch_bridge.save_pth).
  - StableHLO (the JAX package's jax.export artifact) has no torch
    counterpart and raises, naming the JAX package's command.
  - OpenVINO `mo` conversion runs as a subprocess when present (gated).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from yogo_tpu_torch.models.yogo import CONVNEXT_DEPTHS, CONVNEXT_DIMS, YOGO, resolve_device
from yogo_tpu_torch.ops.grid import WH_CLAMP, cell_offsets
from yogo_tpu_torch.ops.quant import fold_block_params
from yogo_tpu_torch.utils import onnx_proto as op
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.onnx_interp import run_model
from yogo_tpu_torch.utils.weights import state_dict_from_flax

PARITY_RTOL = 1e-3
PARITY_ATOL = 1e-5


def _folded_conv_params(
    conv: Dict[str, Any], bn_params, bn_stats, eps=1e-5
) -> Tuple[np.ndarray, np.ndarray]:
    """HWIO kernel + optional BN -> OIHW weight and bias with BN folded
    (the int8 path's fold, ops/quant.py, transposed for ONNX)."""
    w, b = fold_block_params(conv, bn_params, bn_stats, eps=eps)
    return np.transpose(w, (3, 2, 0, 1)), b


def _emit_conv_stack(nodes, inits, cur, defn, params, stats) -> str:
    """Emit the plain conv-stack backbone (BN folded). Returns the output name."""
    for i, s in enumerate(defn.blocks):
        conv = params[f"conv{i}"]
        bn_p = params.get(f"bn{i}")
        bn_s = stats.get(f"bn{i}")
        w, b = _folded_conv_params(conv, bn_p, bn_s)
        inits.append(op.tensor_proto(f"w{i}", w))
        inits.append(op.tensor_proto(f"b{i}", b))
        out = f"conv{i}_out"
        nodes.append(
            op.node(
                "Conv",
                [cur, f"w{i}", f"b{i}"],
                [out],
                strides=[s.stride, s.stride],
                pads=[s.padding] * 4,
                kernel_shape=[s.kernel, s.kernel],
            )
        )
        cur = out
        if s.act == "leaky_relu":
            nodes.append(op.node("LeakyRelu", [cur], [f"act{i}"], alpha=0.01))
            cur = f"act{i}"
        elif s.act == "silu":
            nodes.append(op.node("Sigmoid", [cur], [f"sig{i}"]))
            nodes.append(op.node("Mul", [cur, f"sig{i}"], [f"act{i}"]))
            cur = f"act{i}"
        elif s.act is not None:
            # fail fast: silently omitting an activation the flax side
            # applies would only surface as an opaque parity-gate mismatch
            raise NotImplementedError(
                f"ONNX export has no emitter for activation '{s.act}'"
            )
    return cur


_NCHW_TO_NHWC = [0, 2, 3, 1]
_NHWC_TO_NCHW = [0, 3, 1, 2]


def _emit_convnext(nodes, inits, cur, model: YOGO, params) -> str:
    """Emit the native ConvNeXt-Small backbone + YOGO format head
    (structure: yogo_tpu_torch.models.yogo.ConvNeXtSmall). Convs run NCHW;
    LayerNorm / MLP segments run NHWC via Transpose pairs - the same shape
    torch.onnx gives timm convnext exports."""
    uid = [0]

    def name(tag):
        uid[0] += 1
        return f"cnx_{tag}_{uid[0]}"

    def add_init(tag, arr):
        n = name(tag)
        inits.append(op.tensor_proto(n, np.asarray(arr, np.float32)))
        return n

    def conv(cur, p, stride, pads, group=1):
        # flax HWIO -> ONNX OIHW; depthwise flax kernel is (kh,kw,1,O)
        w = np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))
        wn = add_init("w", w)
        bn = add_init("b", np.asarray(p["bias"], np.float32))
        out = name("conv")
        attrs = dict(
            strides=[stride, stride],
            pads=[pads] * 4,
            kernel_shape=[w.shape[2], w.shape[3]],
        )
        if group > 1:
            attrs["group"] = group
        nodes.append(op.node("Conv", [cur, wn, bn], [out], **attrs))
        return out

    def transpose(cur, perm):
        out = name("perm")
        nodes.append(op.node("Transpose", [cur], [out], perm=perm))
        return out

    def layernorm(cur_nhwc, p):
        sn = add_init("ln_s", p["scale"])
        bn = add_init("ln_b", p["bias"])
        out = name("ln")
        nodes.append(
            op.node(
                "LayerNormalization",
                [cur_nhwc, sn, bn],
                [out],
                axis=-1,
                epsilon=1e-6,
            )
        )
        return out

    def dense(cur_nhwc, p):
        wn = add_init("dw", np.asarray(p["kernel"], np.float32))  # (C, D)
        bn = add_init("db", np.asarray(p["bias"], np.float32))
        mm = name("mm")
        nodes.append(op.node("MatMul", [cur_nhwc, wn], [mm]))
        out = name("dense")
        nodes.append(op.node("Add", [mm, bn], [out]))
        return out

    def gelu(cur):
        # exact erf GELU: 0.5 * x * (1 + erf(x / sqrt(2))) - matching both
        # the flax model (approximate=False) and torch.onnx's export of
        # timm's nn.GELU
        inv_sqrt2 = add_init("g1", np.float32(1.0 / np.sqrt(2.0)).reshape(()))
        half = add_init("gh", np.float32(0.5).reshape(()))
        one = add_init("g2", np.float32(1.0).reshape(()))
        t1 = name("t1")
        nodes.append(op.node("Mul", [cur, inv_sqrt2], [t1]))
        er = name("erf")
        nodes.append(op.node("Erf", [t1], [er]))
        t2 = name("t2")
        nodes.append(op.node("Add", [er, one], [t2]))
        t3 = name("t3")
        nodes.append(op.node("Mul", [cur, t2], [t3]))
        out = name("gelu")
        nodes.append(op.node("Mul", [t3, half], [out]))
        return out

    depths = CONVNEXT_DEPTHS
    dims = CONVNEXT_DIMS

    # stem: patchify conv + LN
    cur = conv(cur, params["stem_conv"], stride=4, pads=0)
    cur = transpose(cur, _NCHW_TO_NHWC)
    cur = layernorm(cur, params["stem_norm"])
    cur = transpose(cur, _NHWC_TO_NCHW)

    for stage, (depth, dim) in enumerate(zip(depths, dims)):
        if stage > 0:
            cur = transpose(cur, _NCHW_TO_NHWC)
            cur = layernorm(cur, params[f"down{stage}_norm"])
            cur = transpose(cur, _NHWC_TO_NCHW)
            cur = conv(cur, params[f"down{stage}_conv"], stride=2, pads=0)
        for blk in range(depth):
            p = params[f"stage{stage}_block{blk}"]
            resid = cur
            cur = conv(cur, p["dwconv"], stride=1, pads=3, group=dim)
            cur = transpose(cur, _NCHW_TO_NHWC)
            cur = layernorm(cur, p["norm"])
            cur = dense(cur, p["pwconv1"])
            cur = gelu(cur)
            cur = dense(cur, p["pwconv2"])
            gn = add_init("gamma", p["gamma"])
            scaled = name("ls")
            nodes.append(op.node("Mul", [cur, gn], [scaled]))
            cur = transpose(scaled, _NHWC_TO_NCHW)
            added = name("res")
            nodes.append(op.node("Add", [resid, cur], [added]))
            cur = added

    # "format time!" head: 1x1 conv -> stride-4 transpose conv
    cur = conv(cur, params["format_conv"], stride=1, pads=0)
    wt = np.asarray(params["format_up"]["kernel"], np.float32)
    # flax ConvTranspose keeps the kernel unflipped (transpose_kernel=False);
    # ONNX ConvTranspose is the gradient-of-conv, so flip spatially, then
    # HWIO -> (C_in, C_out, kH, kW)
    wtn = add_init("wt", np.transpose(wt[::-1, ::-1], (2, 3, 0, 1)))
    btn = add_init("bt", np.asarray(params["format_up"]["bias"], np.float32))
    out = name("up")
    nodes.append(
        op.node(
            "ConvTranspose",
            [cur, wtn, btn],
            [out],
            strides=[4, 4],
            pads=[0, 0, 0, 0],
            kernel_shape=[4, 4],
        )
    )
    return out


def build_onnx(
    model: YOGO, variables: Dict[str, Any], batch_size: int = 1
) -> bytes:
    """Emit an ONNX ModelProto for a YOGO model: uint8 input ->
    decoded (B, 5+C, Sy, Sx) predictions with softmaxed classes."""
    defn = model.defn
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    h, w_in = model.img_size
    Sx, Sy = model.grid
    nodes: List[bytes] = []
    inits: List[bytes] = []

    nodes.append(op.node("Cast", ["images"], ["x_f32"], to=op.FLOAT))
    cur = "x_f32"
    if model.normalize_images:
        inits.append(op.tensor_proto("c255", np.float32(255.0).reshape(())))
        nodes.append(op.node("Div", [cur, "c255"], ["x_norm"]))
        cur = "x_norm"

    if defn.family == "conv_stack":
        cur = _emit_conv_stack(nodes, inits, cur, defn, params, stats)
    elif defn.family == "convnext":
        cur = _emit_convnext(nodes, inits, cur, model, params)
    else:  # pragma: no cover - YOGO.module refuses other families too
        raise NotImplementedError(f"ONNX export for family {defn.family} not supported")

    # ---- decode head (reference: yogo/model.py:277-313) ----
    def slice_channels(name, start, end):
        inits.append(
            op.tensor_proto(f"{name}_starts", np.array([start], np.int64))
        )
        inits.append(op.tensor_proto(f"{name}_ends", np.array([end], np.int64)))
        nodes.append(
            op.node(
                "Slice",
                [cur, f"{name}_starts", f"{name}_ends", "axes1"],
                [name],
            )
        )
        return name

    inits.append(op.tensor_proto("axes1", np.array([1], np.int64)))
    tx = slice_channels("tx", 0, 1)
    ty = slice_channels("ty", 1, 2)
    tw = slice_channels("tw", 2, 3)
    th = slice_channels("th", 3, 4)
    to = slice_channels("to", 4, 5)
    cls = slice_channels("cls", 5, 5 + model.num_classes)

    cxs, cys = cell_offsets(Sx, Sy)
    inits.append(op.tensor_proto("Cxs", cxs[None, None]))
    inits.append(op.tensor_proto("Cys", cys[None, None]))
    inits.append(
        op.tensor_proto("inv_sx", np.float32(1.0 / Sx).reshape(()))
    )
    inits.append(
        op.tensor_proto("inv_sy", np.float32(1.0 / Sy).reshape(()))
    )
    inits.append(
        op.tensor_proto(
            "aw",
            np.float32(model.anchor_w * model.width_multiplier).reshape(()),
        )
    )
    inits.append(
        op.tensor_proto(
            "ah",
            np.float32(model.anchor_h * model.height_multiplier).reshape(()),
        )
    )
    inits.append(op.tensor_proto("wh_max", np.float32(WH_CLAMP).reshape(())))

    nodes += [
        op.node("Sigmoid", [tx], ["sx_"]),
        op.node("Mul", ["sx_", "inv_sx"], ["sxs"]),
        op.node("Add", ["sxs", "Cxs"], ["xc"]),
        op.node("Sigmoid", [ty], ["sy_"]),
        op.node("Mul", ["sy_", "inv_sy"], ["sys"]),
        op.node("Add", ["sys", "Cys"], ["yc"]),
        op.node("Clip", [tw, "", "wh_max"], ["tw_c"]),
        op.node("Exp", ["tw_c"], ["tw_e"]),
        op.node("Mul", ["tw_e", "aw"], ["wbox"]),
        op.node("Clip", [th, "", "wh_max"], ["th_c"]),
        op.node("Exp", ["th_c"], ["th_e"]),
        op.node("Mul", ["th_e", "ah"], ["hbox"]),
        op.node("Sigmoid", [to], ["obj"]),
        op.node("Softmax", [cls], ["probs"], axis=1),
        op.node(
            "Concat",
            ["xc", "yc", "wbox", "hbox", "obj", "probs"],
            ["preds"],
            axis=1,
        ),
    ]

    graph = op.graph(
        nodes,
        name="yogo",
        inputs=[
            op.value_info(
                "images", op.UINT8, (batch_size, model.input_channels, h, w_in)
            )
        ],
        outputs=[
            op.value_info(
                "preds", op.FLOAT, (batch_size, 5 + model.num_classes, Sy, Sx)
            )
        ],
        initializers=inits,
    )
    return op.model(graph, opset=17)


def verify_onnx(
    model: YOGO,
    variables: Dict[str, Any],
    model_bytes: bytes,
    batch_size: int = 1,
    seed: int = 0,
    device=None,
) -> float:
    """Assert ONNX output == the port's float32 forward at the reference
    tolerance, both run on `device` (default CUDA; an error without one)
    with TF32 off. The graph runs in the built-in interpreter
    (utils/onnx_interp). Returns the max abs deviation."""
    device = resolve_device(device)
    h, w = model.img_size
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (batch_size, model.input_channels, h, w)).astype(
        np.uint8
    )

    x_ref = x.astype(np.float32)
    if model.normalize_images:
        x_ref = x_ref / 255.0
    # the decoded float32 forward: YOGO.apply holds no_tf32, so its convs on
    # the card are float32, not TF32 (the reference's parity check is an f32
    # CPU forward: yogo/utils/export_model.py:123-133)
    ref = model.with_compute_dtype(torch.float32)
    stack = ref.module(device)
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = (
        ref.apply(stack, torch.from_numpy(x_ref).to(device), inference=True)
        .cpu()
        .numpy()
    )

    got = run_model(model_bytes, {"images": x}, device=device)[0]

    np.testing.assert_allclose(
        got,
        want,
        rtol=PARITY_RTOL,
        atol=PARITY_ATOL,
        err_msg="onnx and yogo_tpu_torch outputs are far apart",
    )
    return float(np.max(np.abs(got - want)))


def export_stablehlo(*_args, **_kwargs) -> None:
    """Takes the JAX package's arguments and raises: StableHLO is a
    jax.export artifact, which the JAX package writes and torch has no
    counterpart for (a torch.export program would be another format, one
    the JAX package lacks)."""
    raise NotImplementedError(
        "--format stablehlo is a JAX artifact; export it with "
        "`python -m yogo_tpu export --format stablehlo`"
    )


def _with_ext(p: Path, ext: str) -> Path:
    # NOT Path.with_suffix: that truncates dotted stems ("best.v2" ->
    # "best.onnx"), silently colliding exports of best.v1/best.v2.ckpt
    name = p.name[: -len(ext)] if p.name.endswith(ext) else p.name
    return p.parent / (name + ext)


def do_export(args) -> None:
    """The `export` command: .onnx through the parity gate (or .pth) next to
    the checkpoint or at --output-filename, on args.device (default CUDA;
    an error without one, whatever the format)."""
    device = resolve_device(getattr(args, "device", None))
    fmt = getattr(args, "format", "onnx")
    if fmt == "stablehlo":
        export_stablehlo()

    input_path = Path(args.input)
    model, variables, meta = load_any(input_path)

    if args.crop_height is not None:
        img_h = int(round(args.crop_height * model.img_size[0]))
        model = model.resize(img_h)

    out = (
        Path(args.output_filename)
        if args.output_filename
        else input_path.with_suffix("")
    )

    if fmt == "pth":
        from yogo_tpu_torch.utils.torch_bridge import save_pth

        target = _with_ext(out, ".pth")
        save_pth(
            target,
            model,
            variables,
            classes=meta.get("classes") or meta.get("class_names"),
            model_name=meta.get("model_name"),
            step=meta.get("step", 0),
            epoch=meta.get("epoch", 0),
        )
        print(f"exported to {target}")
        return

    onnx_filename = _with_ext(out, ".onnx")
    model_bytes = build_onnx(model, variables)
    verified_dev = None  # set when the simplify path already ran the gate
    # --simplify: the reference runs onnx-simplifier here (reference:
    # yogo/utils/export_model.py:111-117). The writer already emits a
    # constant-folded graph with BatchNorm folded into convs (the main
    # transformations onnxsim would apply); run onnxsim on top when it is
    # installed, and say so rather than silently ignoring the flag.
    if getattr(args, "simplify", False):
        try:
            import onnxsim  # type: ignore

            import onnx  # type: ignore

            simplified, ok = onnxsim.simplify(
                onnx.load_from_string(model_bytes)
            )
            if ok:
                # the simplified graph must still pass the parity gate (it
                # may introduce ops the fallback interpreter lacks); fall
                # back to the already-valid unsimplified graph if not
                candidate = simplified.SerializeToString()
                try:
                    verified_dev = verify_onnx(
                        model, variables, candidate, device=device
                    )
                    model_bytes = candidate
                except Exception as e:
                    print(f"--simplify: simplified graph failed the parity "
                          f"gate ({e!r}); keeping the unsimplified graph")
        except ImportError:
            print(
                "--simplify: onnx-simplifier not installed; exporting the "
                "writer's already-BN-folded graph unchanged"
            )
        except Exception as e:
            # onnxsim routinely raises on graphs it has not seen; a
            # simplify failure must not abort an export whose unsimplified
            # graph is valid
            print(f"--simplify: onnxsim failed ({e!r}); exporting the "
                  "unsimplified graph")
    # the simplify path already verified these exact bytes - don't pay the
    # reference forward + full interpreter execution a second time
    max_dev = (
        verified_dev
        if verified_dev is not None
        else verify_onnx(model, variables, model_bytes, device=device)
    )
    onnx_filename.write_bytes(model_bytes)
    success_msg = (
        f"exported to {onnx_filename} (parity max dev {max_dev:.2e}, "
        f"gate rtol {PARITY_RTOL}/atol {PARITY_ATOL})"
    )

    # OpenVINO IR conversion, when the `mo` converter exists on PATH
    # (reference: yogo/utils/export_model.py:138-150)
    if shutil.which("mo"):
        mo_res = subprocess.run(
            [
                "mo",
                "--input_model",
                str(onnx_filename),
                "--output_dir",
                str(onnx_filename.resolve().parents[0]),
                "--compress_to_fp16",
                "True",
            ],
            capture_output=True,
            text=True,
        )
        if mo_res.returncode == 0:
            success_msg += (
                f", {onnx_filename.with_suffix('.xml')}, "
                f"{onnx_filename.with_suffix('.bin')}"
            )
        else:
            # do NOT claim .xml/.bin files that were never written
            tail = (mo_res.stderr or mo_res.stdout or "").strip()[-500:]
            print(
                f"OpenVINO mo failed (exit {mo_res.returncode}); the .onnx "
                f"export above is still valid. mo output: {tail}"
            )
    print(success_msg)
