"""How the int8 golden gates depend on the calibration batch, in the JAX
package and in the port, on the CPU.

The trained full-resolution base_model (tests/goldens/) is quantized twice
by each package's `quantize_conv_stack` with the default skip rule: once
calibrated on the 4 golden frames (what `predict(quantize=True,
batch_size=4)` builds), once on the same frames tiled to a batch of 64
(what `predict` builds at its default batch size from 64 such frames, and
what chip_smoke.py's phase 9 times). Each program runs the 4 frames and
is held to the gates of tests/test_golden_fullres_int8.py against the
committed bf16 detections. The stride subsample of the calibration
percentiles (every size // 1e6-th element) walks other elements in a
batch of 64 than in a batch of 4, so the two programs differ.

Run from the repository root (full resolution at B=64: a peak of 5.8 GiB
and 170 s on 8 CPU cores; it is not a tier-1 test):

    python -m tests.int8_calibration_witness

It prints one JSON object: per package and calibration batch the
per-tensor scales and the gates (yogo_tpu_torch/tools/golden_scene.py's
int8_gates), and the largest relative difference of the port's scales
from JAX's.
"""

import json
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

from tests.test_golden_fullres import gen_test_images  # noqa: E402
from tests.test_golden_fullres_int8 import CKPT_PATH, GOLDEN_PATH  # noqa: E402
from yogo_tpu.ops import quant as jq  # noqa: E402
from yogo_tpu.ops.postprocess import format_preds as jax_format_preds  # noqa: E402
from yogo_tpu.utils.checkpoint import load_any as jax_load_any  # noqa: E402
from yogo_tpu_torch.ops import quant as tq  # noqa: E402
from yogo_tpu_torch.ops.postprocess import format_preds  # noqa: E402
from yogo_tpu_torch.tools.golden_scene import int8_gates  # noqa: E402
from yogo_tpu_torch.utils.checkpoint import load_any  # noqa: E402

TILED_BATCH = 64


def golden_frames() -> np.ndarray:
    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        gen_test_images(Path(d), n=4)
        return np.stack([np.asarray(Image.open(p)) for p in sorted(Path(d).glob("*.png"))])[:, None]


def main() -> dict:
    golden = np.load(GOLDEN_PATH)
    frames = golden_frames()
    calib = {"b4": frames, f"b{TILED_BATCH}": np.concatenate([frames] * (TILED_BATCH // len(frames)))}
    jm, jv, _ = jax_load_any(CKPT_PATH)
    tm, tv, _ = load_any(CKPT_PATH)
    skip = tq.default_skip_blocks(tm.defn, tm.input_channels)
    assert skip == jq.default_skip_blocks(jm.defn, jm.input_channels)
    n_tensor = len(tm.defn.blocks) - 1
    report = {"skip_blocks": list(skip), "frames": list(frames.shape)}
    fwd = jax.jit(lambda qp, x: jq.quantized_forward(jm, qp, x))
    for name, batch in calib.items():
        qj = jq.quantize_conv_stack(jm, jv, [batch], skip_blocks=skip)
        preds = np.asarray(fwd(qj, frames), np.float32)
        jax_scales = np.asarray(qj["scales"], np.float32)
        report[f"jax_{name}"] = {
            "scales": jax_scales[:n_tensor].tolist(),
            "gates": int8_gates([jax_format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds],
                                golden),
        }
        del qj, preds
        qt = tq.quantize_conv_stack(tm, tv, [batch], skip_blocks=skip, device="cpu")
        preds = tq.quantized_forward(tm, qt, torch.from_numpy(frames)).numpy()
        port_scales = qt["scales"].numpy()
        report[f"port_{name}"] = {
            "scales": port_scales[:n_tensor].tolist(),
            "gates": int8_gates([format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds], golden),
            "payload_max_rel_diff_vs_jax": float(
                np.max(np.abs(port_scales - jax_scales) / np.maximum(np.abs(jax_scales), 1e-30))),
        }
        del qt, preds
    return report


if __name__ == "__main__":
    print(json.dumps(main()))
