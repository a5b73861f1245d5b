"""The port's export (yogo_tpu_torch/utils/{export_model,onnx_proto,
onnx_interp}.py) against the JAX package's on the CPU: the ONNX bytes of
every architecture, the interpreters on the same graph, the parity gate,
the `export` command, and the proto writer and parser cases of
tests/test_onnx_cross_validation.py that need no reference torch model.

The weights are the port's seeded init carried into the flax layout
(utils/weights.flax_from_state_dict), so both packages get the same numpy
variables. JAX is imported inside the tests that compare with it, so the
card's test runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_export.py -m cuda
"""

import dataclasses
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yogo_tpu_torch.__main__ import main
from yogo_tpu_torch.models.defns import MODELS
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.utils import export_model as te
from yogo_tpu_torch.utils import onnx_proto as op
from yogo_tpu_torch.utils.checkpoint import load_any, save_checkpoint
from yogo_tpu_torch.utils.onnx_interp import run_model
from yogo_tpu_torch.utils.weights import flax_from_state_dict

GOLDEN_FULLRES = "tests/goldens/trained_base_model_fullres.ckpt"
GOLDEN_HALF = "tests/goldens/trained_half_filters.ckpt"
# the interpreters on one graph: torch's CPU convs against XLA's, summed in
# other orders; decoded outputs of a head of O(1) logits
INTERP_RTOL = INTERP_ATOL = 1e-5
# the architectures both packages have (the swin and vitdet families are the port's own)
BOTH = sorted(n for n in MODELS if MODELS[n](2).family not in ("swin", "vitdet"))


def jax_export():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from yogo_tpu.models.yogo import YOGO as JYOGO
    from yogo_tpu.utils import export_model as je

    return JYOGO, je


def seeded(version, hw=(32, 48), seed=5, **kw):
    """(port config, JAX config, flax-layout numpy variables of the port's
    seeded init)."""
    JYOGO, _ = jax_export()
    model = YOGO.create(hw, 0.1, 0.12, 3, model_version=version, **kw)
    net = model.init(torch.Generator().manual_seed(seed), device="cpu")
    jmodel = JYOGO.create(hw, 0.1, 0.12, 3, model_version=version, **kw)
    return model, jmodel, flax_from_state_dict(net.state_dict())


def perturbed(version, hw=(32, 48), seed=5, **kw):
    """seeded() with BN statistics of a trained net (mean ~ N(0, 0.2), var
    in [0.5, 2]) and the head scaled by 1e-3 (tests/test_infer_export.py's
    non-identity case), so w/h = anchor * exp(t) stays O(1): an untrained
    head gives logits in the hundreds, whose exp amplifies the interpreters'
    last-bit differences past any relative gate."""
    model, jmodel, var = seeded(version, hw, seed, **kw)
    rng = np.random.default_rng(seed)
    for leaf in var["batch_stats"].values():
        leaf["mean"] = rng.normal(0.0, 0.2, leaf["mean"].shape).astype(np.float32)
        leaf["var"] = rng.uniform(0.5, 2.0, leaf["var"].shape).astype(np.float32)
    head = f"conv{len(model.defn.blocks) - 1}"
    var["params"][head] = {k: v * 1e-3 for k, v in var["params"][head].items()}
    return model, jmodel, var


def golden_half():
    """(port config, variables) of the trained half_filters checkpoint, 96x128."""
    model, var, _ = load_any(GOLDEN_HALF)
    return model, var


def uint8_batch(model, b=2, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, (b, model.input_channels, *model.img_size)
    ).astype(np.uint8)


# ------------------------------------------------------------- ONNX bytes
@pytest.mark.parametrize("version", BOTH)
def test_build_onnx_bytes_equal_jax_s_for_every_architecture(version):
    """The 11 conv stacks and ConvNeXt at 32x48, B=2: byte-equal graphs,
    and the port's gate passes on its own graph."""
    _, je = jax_export()
    model, jmodel, var = seeded(version)
    blob = te.build_onnx(model, var, batch_size=2)
    assert blob == je.build_onnx(jmodel, var, batch_size=2)
    te.verify_onnx(model, var, blob, batch_size=2, seed=5, device="cpu")


@pytest.mark.parametrize("case", ["nonidentity_bn", "normalized", "silu_crop"])
def test_build_onnx_bytes_equal_jax_s_for_the_variants(case):
    """tests/test_infer_export.py's variants: trained-like BN statistics
    (folded), x/255 baked into the graph, SiLU, and a crop-resized model;
    all with perturbed() weights, so the gate's deviation is absolute too."""
    _, je = jax_export()
    if case == "nonidentity_bn":
        model, jmodel, var = perturbed("quarter_filters", (48, 64), seed=3)
    elif case == "normalized":
        model, jmodel, var = perturbed("quarter_filters", (48, 64), seed=1, normalize_images=True)
    else:
        model, jmodel, var = perturbed("silu_model", (48, 64), seed=2)
        model, jmodel = model.resize(24), jmodel.resize(24)
        assert model.img_size == (24, 64) and model.height_multiplier == 2.0
    blob = te.build_onnx(model, var)
    assert blob == je.build_onnx(jmodel, var)
    parsed = op.parse_model(blob)
    assert parsed["producer"] == "yogo_tpu"
    assert (parsed["inputs"], parsed["outputs"]) == (["images"], ["preds"])
    assert not any(n["op_type"] == "BatchNormalization" for n in parsed["nodes"])
    assert any(n["op_type"] == "Div" for n in parsed["nodes"]) == (case == "normalized")
    max_dev = te.verify_onnx(model, var, blob, device="cpu")
    assert max_dev < 1e-2


# ------------------------------------------------------------ interpreter
@pytest.mark.parametrize("case", ["golden_half_96x128", "base_model", "silu_model",
                                  "quarter_normalized", "convnext_small"])
def test_interpreter_agrees_with_jax_s_on_the_same_graph(case):
    """run_model (torch convs and matmuls, numpy elsewhere) against the JAX
    package's (lax convs) on the same bytes, rtol = atol = 1e-5. Measured
    max |diff| / (atol + rtol |jax|) on the CPU: 0.024 (golden half_filters),
    0.0045 (base_model, silu_model), 0 (quarter, normalized), 0.0088
    (ConvNeXt)."""
    from yogo_tpu.utils.onnx_interp import run_model as jax_run_model

    if case == "golden_half_96x128":
        model, var = golden_half()
    elif case == "quarter_normalized":
        model, _, var = perturbed("quarter_filters", seed=1, normalize_images=True)
    elif case == "convnext_small":
        model, _, var = seeded("convnext_small")
    else:
        model, _, var = perturbed(case)
    blob = te.build_onnx(model, var, batch_size=2)
    x = uint8_batch(model)
    got = run_model(blob, {"images": x}, device="cpu")[0]
    want = jax_run_model(blob, {"images": x})[0]
    assert got.shape == want.shape == (2, 5 + model.num_classes, model.Sy, model.Sx)
    np.testing.assert_allclose(got, want, rtol=INTERP_RTOL, atol=INTERP_ATOL)


def test_parity_gate_passes_and_bites():
    """verify_onnx passes the trained graph and fails the same graph with
    one weight of block 3 moved by 0.5."""
    model, var = golden_half()
    assert te.verify_onnx(model, var, te.build_onnx(model, var), device="cpu") < 1e-5
    bad = {"params": {k: dict(v) for k, v in var["params"].items()},
           "batch_stats": var["batch_stats"]}
    kernel = bad["params"]["conv3"]["kernel"].copy()
    kernel[1, 1, 0, 0] += 0.5
    bad["params"]["conv3"]["kernel"] = kernel
    with pytest.raises(AssertionError, match="outputs are far apart"):
        te.verify_onnx(model, var, te.build_onnx(model, bad), device="cpu")


def test_unknown_activation_fails_fast():
    model, _, var = seeded("quarter_filters", (48, 64))
    defn = model.defn
    blocks = tuple(dataclasses.replace(s, act="gelu") if i == 0 else s
                   for i, s in enumerate(defn.blocks))
    with pytest.raises(NotImplementedError, match="gelu"):
        te._emit_conv_stack([], [], "x", dataclasses.replace(defn, blocks=blocks),
                            var["params"], var["batch_stats"])


# -------------------------------------------------------------------- CLI
def test_export_cli_writes_the_jax_package_s_file_and_pth_round_trips(tmp_path, capsys):
    """`export <golden 772x1032 ckpt> --device cpu` writes the bytes of the
    JAX package's do_export; `--format pth` loads in the JAX package's
    load_any to the .ckpt's variables."""
    from yogo_tpu.utils.checkpoint import load_any as jload_any

    _, je = jax_export()
    main(["export", GOLDEN_FULLRES, "--device", "cpu", "--output-filename", str(tmp_path / "port")])
    assert "parity max dev" in capsys.readouterr().out
    je.do_export(SimpleNamespace(input=GOLDEN_FULLRES, crop_height=None, simplify=True,
                                 output_filename=str(tmp_path / "jax"), format="onnx"))
    assert (tmp_path / "port.onnx").read_bytes() == (tmp_path / "jax.onnx").read_bytes()

    main(["export", GOLDEN_FULLRES, "--device", "cpu", "--format", "pth",
          "--output-filename", str(tmp_path / "port")])
    jm, jv, jmeta = jload_any(tmp_path / "port.pth")
    m, v, meta = load_any(GOLDEN_FULLRES)
    assert jm.img_size == m.img_size and jmeta["class_names"] == meta["classes"]
    flat = {(c, k): a for c, d in v["params"].items() for k, a in d.items()}
    assert flat.keys() == {(c, k) for c, d in jv["params"].items() for k in d}
    for (c, k), a in flat.items():
        np.testing.assert_array_equal(np.asarray(jv["params"][c][k]), a)
    for c, d in v["batch_stats"].items():
        for k, a in d.items():
            np.testing.assert_array_equal(np.asarray(jv["batch_stats"][c][k]), a)


def test_export_cli_crop_height_matches_jax_s(tmp_path):
    _, je = jax_export()
    model, _, var = seeded("quarter_filters", (48, 64))
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, model, var, classes=["a", "b", "c"])
    main(["export", str(ckpt), "--device", "cpu", "--crop-height", "0.25", "--no-simplify",
          "--output-filename", str(tmp_path / "port")])
    je.do_export(SimpleNamespace(input=str(ckpt), crop_height=0.25, simplify=False,
                                 output_filename=str(tmp_path / "jax"), format="onnx"))
    blob = (tmp_path / "port.onnx").read_bytes()
    assert blob == (tmp_path / "jax.onnx").read_bytes()
    cropped = model.resize(12)
    out = run_model(blob, {"images": np.zeros((1, 1, 12, 64), np.uint8)}, device="cpu")[0]
    assert out.shape == (1, 8, cropped.Sy, cropped.Sx)


def test_export_keeps_dotted_stems_and_explicit_extensions(tmp_path):
    model, _, var = seeded("quarter_filters", (48, 64), seed=0)
    ckpt = tmp_path / "best.v2.ckpt"
    save_checkpoint(ckpt, model, var, classes=["a", "b", "c"])
    main(["export", str(ckpt), "--device", "cpu", "--no-simplify"])
    assert (tmp_path / "best.v2.onnx").exists() and not (tmp_path / "best.onnx").exists()
    main(["export", str(ckpt), "--device", "cpu", "--output-filename", str(tmp_path / "explicit.onnx")])
    assert (tmp_path / "explicit.onnx").exists() and not (tmp_path / "explicit.onnx.onnx").exists()
    main(["export", str(ckpt), "--device", "cpu", "--format", "pth"])
    assert (tmp_path / "best.v2.pth").exists()


def test_stablehlo_raises_naming_the_jax_package_and_import_errors_exit_1(monkeypatch, capsys):
    with pytest.raises(NotImplementedError, match="python -m yogo_tpu export --format stablehlo"):
        main(["export", "m.ckpt", "--device", "cpu", "--format", "stablehlo"])

    def missing(args):
        raise ImportError("no module named onnx")

    monkeypatch.setattr(te, "do_export", missing)
    with pytest.raises(SystemExit) as e:
        main(["export", "m.ckpt", "--device", "cpu"])
    assert e.value.code == 1
    assert "export dependencies missing: no module named onnx" in capsys.readouterr().out


def test_export_without_a_device_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    model, _, var = seeded("quarter_filters", (48, 64), seed=0)
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, model, var, classes=["a", "b", "c"])
    for fmt in ("onnx", "pth"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["export", str(ckpt), "--format", fmt])
    blob = te.build_onnx(model, var)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.verify_onnx(model, var, blob)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_model(blob, {"images": uint8_batch(model, b=1)})
    assert not list(tmp_path.glob("m.onnx")) and not list(tmp_path.glob("m.pth"))


@pytest.mark.parametrize("mo_ok", [True, False])
def test_openvino_mo_runs_when_on_path(monkeypatch, tmp_path, capsys, mo_ok):
    """OpenVINO's `mo` runs after the gate when it is on PATH (reference:
    yogo/utils/export_model.py:138-150); a failing one is reported, and no
    .xml / .bin is claimed (tests/test_gated_paths.py's fake `mo`)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    mo = bindir / "mo"
    arglog = tmp_path / "mo_args.txt"
    mo.write_text(
        "#!/usr/bin/env bash\n"
        f'echo "$@" > {arglog}\n'
        + ('out=""; model=""\n'
           'while [ $# -gt 0 ]; do\n'
           '  case "$1" in\n'
           '    --input_model) model="$2"; shift 2;;\n'
           '    --output_dir) out="$2"; shift 2;;\n'
           "    *) shift;;\n"
           "  esac\n"
           "done\n"
           'touch "$out/$(basename "$model" .onnx).xml" "$out/$(basename "$model" .onnx).bin"\n'
           if mo_ok else 'echo "unsupported op: Futz" >&2\nexit 3\n')
    )
    mo.chmod(mo.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    model, _, var = seeded("quarter_filters", (48, 64), seed=0)
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, model, var, classes=["a", "b", "c"])
    main(["export", str(ckpt), "--device", "cpu", "--output-filename", str(tmp_path / "exported")])
    out = capsys.readouterr().out
    assert (tmp_path / "exported.onnx").exists()
    assert "--compress_to_fp16 True" in arglog.read_text()
    assert (tmp_path / "exported.xml").exists() == mo_ok
    assert ("exported.xml" in out) == mo_ok
    if not mo_ok:
        assert "mo failed (exit 3)" in out and "unsupported op: Futz" in out


# ---------------------------------------- proto writer / parser / op cases
def test_writer_emits_attributes_in_the_attribute_field():
    """NodeProto.attribute is field 5 (7 is `domain`): a parser that reads
    field 5 sees the Conv strides and pads of the writer's graph."""
    model, _, var = seeded("base_model", (48, 64), seed=0)
    convs = [n for n in op.parse_model(te.build_onnx(model, var))["nodes"] if n["op_type"] == "Conv"]
    assert convs and any(n["attrs"].get("strides") == [2, 2] for n in convs)
    assert all("pads" in n["attrs"] for n in convs)


def test_parser_reads_what_the_jax_package_s_parser_reads():
    """Non-packed and absent repeated floats, int32_data (negative values as
    10-byte varints), a tensor with no data field, numpy-float attributes."""
    from yogo_tpu.utils import onnx_proto as jop

    nonpacked = (op.enc_str(1, "scales") + op.enc_float(7, 1.5) + op.enc_float(7, 2.5)
                 + op.enc_varint(20, op.ATTR_FLOATS))
    assert op.parse_attribute(nonpacked) == jop.parse_attribute(nonpacked) == ("scales", [1.5, 2.5])
    empty = op.enc_str(1, "scales") + op.enc_varint(20, op.ATTR_FLOATS)
    assert op.parse_attribute(empty) == ("scales", [])

    body = (op.enc_packed_varints(1, [2, 2]) + op.enc_varint(2, op.INT32)
            + op.enc_varint(5, 1) + op.enc_varint(5, (1 << 64) - 2) + op.enc_varint(5, 3)
            + op.enc_varint(5, 4) + op.enc_str(8, "t"))
    name, arr = op.parse_tensor(body)
    assert name == "t" and arr.dtype == np.int32
    np.testing.assert_array_equal(arr, [[1, -2], [3, 4]])
    np.testing.assert_array_equal(arr, jop.parse_tensor(body)[1])

    missing = op.enc_packed_varints(1, [2]) + op.enc_varint(2, op.INT32) + op.enc_str(8, "t")
    with pytest.raises(ValueError, match="no supported data field"):
        op.parse_tensor(missing)

    assert op.attribute("alpha", np.float32(0.1)) == op.attribute("alpha", 0.10000000149011612)
    assert op.attribute("alpha", np.float32(0.1)) == jop.attribute("alpha", np.float32(0.1))


def _one_node_model(nodes, inputs, outputs, inits=()):
    return op.model(op.graph(nodes, "t", [op.value_info(n, op.FLOAT, s) for n, s in inputs],
                             [op.value_info(n, op.FLOAT, s) for n, s in outputs], list(inits)))


def test_interpreter_ops_reshape_split_slice():
    """Reshape's 0 copies the input dim; an uneven equal Split makes the
    last chunk smaller (opset 18); Slice's optional axes / steps may be
    absent or ''."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    m = _one_node_model([op.node("Reshape", ["x", "shape"], ["y"])], [("x", x.shape)], [("y", (2, 12))],
                        [op.tensor_proto("shape", np.asarray([0, -1], np.int64))])
    np.testing.assert_array_equal(run_model(m, {"x": x}, device="cpu")[0], x.reshape(2, 12))

    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    m = _one_node_model([op.node("Split", ["x"], ["a", "b", "c"], axis=0)], [("x", x.shape)],
                        [("a", (3, 2)), ("b", (3, 2)), ("c", (1, 2))])
    assert [o.shape for o in run_model(m, {"x": x}, device="cpu")] == [(3, 2), (3, 2), (1, 2)]

    x = np.arange(48, dtype=np.float32).reshape(4, 3, 4)
    inits = [op.tensor_proto("starts", np.array([1], np.int64)),
             op.tensor_proto("ends", np.array([3], np.int64))]
    for ins in (["x", "starts", "ends"], ["x", "starts", "ends", "", ""]):
        m = _one_node_model([op.node("Slice", ins, ["y"])], [("x", x.shape)], [("y", (2, 3, 4))], inits)
        np.testing.assert_array_equal(run_model(m, {"x": x}, device="cpu")[0], x[1:3])


def test_interpreter_asymmetric_conv_pads_and_conv_transpose_crop():
    """Conv pads (top, left, bottom, right) that differ, and ConvTranspose
    pads cropping the full transposed conv, against the JAX package's."""
    from yogo_tpu.utils.onnx_interp import run_model as jax_run_model

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 3, 9, 10)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    wt = rng.normal(size=(3, 2, 4, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    nodes = [op.node("Conv", ["x", "w", "b"], ["y"], strides=[2, 1], pads=[0, 1, 2, 0],
                     kernel_shape=[3, 3]),
             op.node("ConvTranspose", ["x", "wt"], ["z"], strides=[2, 2], pads=[1, 0, 0, 2],
                     kernel_shape=[4, 4])]
    m = _one_node_model(nodes, [("x", x.shape)], [("y", (1, 4, 5, 9)), ("z", (1, 2, 19, 20))],
                        [op.tensor_proto("w", w), op.tensor_proto("b", b), op.tensor_proto("wt", wt)])
    got, want = run_model(m, {"x": x}, device="cpu"), jax_run_model(m, {"x": x})
    assert [g.shape for g in got] == [(1, 4, 5, 9), (1, 2, 19, 20)]
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
def test_gate_and_interpreter_on_the_card(cuda):
    """base_model at 96x128: the gate passes with the reference forward and
    the interpreter's convs on the card, and the interpreter's output on
    the card equals the CPU's within rtol = atol = 1e-5 (TF32 off)."""
    model = YOGO.create((96, 128), 0.1, 0.12, 3)
    var = flax_from_state_dict(model.init(torch.Generator().manual_seed(5), device="cpu").state_dict())
    head = f"conv{len(model.defn.blocks) - 1}"
    var["params"][head] = {k: v * 1e-3 for k, v in var["params"][head].items()}
    blob = te.build_onnx(model, var)
    assert te.verify_onnx(model, var, blob, device="cuda") < te.PARITY_ATOL
    x = uint8_batch(model, b=1)
    np.testing.assert_allclose(run_model(blob, {"images": x}, device="cuda")[0],
                               run_model(blob, {"images": x}, device="cpu")[0], rtol=1e-5, atol=1e-5)
