"""CLI argument parsers (port of yogo_tpu/utils/argparsers.py, which is
flag-compatible with the reference CLI, reference:
yogo/utils/argparsers.py:74-489): `train`, `test`, `export`, `infer` and
`serve` with the same flag names, validating types and defaults as the JAX
package; `--device` defaults to CUDA. `train`, `infer` and `serve
--spatial-parallel N` split each image's rows over N devices (the JAX
package's `test` has no such flag, and neither has this one).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from yogo_tpu_torch.data.split_fractions import SplitFractions

boolean_action = argparse.BooleanOptionalAction

DEVICE_HELP = "torch device (default: cuda, and an error without one; 'cpu' runs on the CPU)"


def uint(val):
    # quirk kept deliberately: like the reference validator (reference:
    # yogo/utils/argparsers.py:14-22) this ACCEPTS 0 despite the message
    # saying "positive" - matching its accept/reject set exactly is part
    # of the flag-compatibility contract (tests/test_cli.py)
    try:
        v = int(val)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{val} is not a positive integer")
    if v < 0:
        raise argparse.ArgumentTypeError(f"{val} is not a positive integer")
    return v


def positive_int(val):
    "a strictly positive integer (extension flags only - no reference quirk)"
    try:
        v = int(val)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{val} is not an integer")
    if v < 1:
        raise argparse.ArgumentTypeError(f"{val} must be >= 1")
    return v


def super_unitary_float(val):
    "a number greater than or equal to 1"
    try:
        v = float(val)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{val} is not a float value")
    if not 1 <= v:
        raise argparse.ArgumentTypeError(f"{v} must be greater than or equal to 1")
    return v


def unsigned_float(val):
    try:
        v = float(val)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{val} is not a float value")
    if not 0 <= v:
        raise argparse.ArgumentTypeError(f"{v} must be greater than 0")
    return v


def unitary_float(val):
    try:
        v = float(val)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{val} is not a float value")
    if not 0 <= v <= 1:
        raise argparse.ArgumentTypeError(f"{v} must be in [0,1]")
    return v


class SplitFractionsAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        try:
            setattr(
                namespace,
                self.dest,
                SplitFractions.from_list(
                    list(map(float, values)), test_paths_present=False
                ),
            )
        except Exception as e:
            parser.error(str(e))


def global_parser():
    parser = argparse.ArgumentParser(
        prog="python -m yogo_tpu_torch",
        description="what can yogo do for you today?",
        allow_abbrev=False,
    )
    subparsers = parser.add_subparsers(help="here is what you can do", dest="task")
    train_parser(
        parser=subparsers.add_parser("train", help="train a model", allow_abbrev=False)
    )
    test_parser(
        parser=subparsers.add_parser("test", help="test a model", allow_abbrev=False)
    )
    export_parser(
        parser=subparsers.add_parser("export", help="export a model", allow_abbrev=False)
    )
    infer_parser(
        parser=subparsers.add_parser(
            "infer", help="infer images using a model", allow_abbrev=False
        )
    )
    serve_parser(
        parser=subparsers.add_parser(
            "serve", help="serve a model over HTTP", allow_abbrev=False
        )
    )
    return parser


def _add_fast_eval_capacity_args(parser):
    """Capacity knobs for the --fast-eval device metrics engine, shared by
    the train (post-training test pass) and test parsers. The device
    engine's state is fixed-shape, so per-image detections / ground-truth
    boxes beyond these caps are dropped (with a warning at the end of the
    run); the host engine caps detections at 1024 and labels not at all."""
    parser.add_argument(
        "--fast-eval-max-detections", type=positive_int, default=256,
        help=(
            "per-image detection capacity of the --fast-eval device "
            "metrics engine (extension); raise for scenes denser than N "
            "obj>thresh cells - cost grows ~quadratically (default: 256)"
        ),
    )
    parser.add_argument(
        "--fast-eval-max-labels", type=positive_int, default=256,
        help=(
            "per-image ground-truth box capacity of the --fast-eval "
            "device metrics engine (extension) (default: 256)"
        ),
    )


def train_parser(parser=None):
    from yogo_tpu_torch.models.defns import MODELS
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df

    if parser is None:
        parser = argparse.ArgumentParser(
            description="commence a training run", allow_abbrev=False
        )

    parser.add_argument(
        "dataset_descriptor_file",
        type=str,
        help="path to yml dataset descriptor file",
    )
    parser.add_argument(
        "--from-pretrained",
        type=Path,
        default=None,
        help="start training from the provided .ckpt checkpoint",
    )
    parser.add_argument(
        "--dataset-split-override",
        action=SplitFractionsAction,
        nargs=3,
        help=(
            "override dataset split fractions, in 'train val test' order - "
            "e.g. '0.7 0.2 0.1'. All data, including test_paths, is randomly "
            "reassigned."
        ),
    )
    parser.add_argument(
        "-bs", "--batch-size", type=uint, default=df.BATCH_SIZE,
        help=f"batch size for training (default: {df.BATCH_SIZE})",
    )
    parser.add_argument(
        "-lr", "--learning-rate", "--lr", type=unitary_float,
        default=df.LEARNING_RATE,
        help=f"learning rate for training (default: {df.LEARNING_RATE})",
    )
    parser.add_argument(
        "--lr-decay-factor", type=super_unitary_float, default=df.DECAY_FACTOR,
        help=(
            "factor by which to decay lr - e.g. '2' gives a final learning "
            f"rate of lr/2 (default: {df.DECAY_FACTOR})"
        ),
    )
    parser.add_argument(
        "--label-smoothing", type=unitary_float, default=df.LABEL_SMOOTHING,
        help=f"label smoothing (default: {df.LABEL_SMOOTHING})",
    )
    parser.add_argument(
        "-wd", "--weight-decay", type=unitary_float, default=df.WEIGHT_DECAY,
        help=f"weight decay for training (default: {df.WEIGHT_DECAY})",
    )
    parser.add_argument(
        "--epochs", type=uint, default=df.EPOCHS,
        help=f"number of epochs to train (default: {df.EPOCHS})",
    )
    parser.add_argument(
        "--no-obj-weight", type=float, default=df.NO_OBJ_WEIGHT,
        help=(
            "weight for the objectness loss when there isn't an object "
            f"(default: {df.NO_OBJ_WEIGHT})"
        ),
    )
    parser.add_argument(
        "--iou-weight", type=float, default=df.IOU_WEIGHT,
        help=f"weight for the iou loss (default: {df.IOU_WEIGHT})",
    )
    parser.add_argument(
        "--classify-weight", type=float, default=df.CLASSIFY_WEIGHT,
        help=f"weight for the classification loss (default: {df.CLASSIFY_WEIGHT})",
    )
    parser.add_argument(
        "--normalize-images", default=False, action=boolean_action,
        help="normalize images into [0,1] - overridden if loading a checkpoint",
    )
    parser.add_argument(
        "--image-hw", default=(772, 1032), nargs=2, type=int,
        help=(
            "height and width of images for training "
            "(e.g. --image-hw 772 1032) (default: 772 1032)"
        ),
    )
    parser.add_argument(
        "--rgb-images", default=False, action=boolean_action,
        help=(
            "use RGB images instead of grayscale - overridden if loading a "
            "checkpoint (defaults to grayscale)"
        ),
    )
    parser.add_argument(
        "--model", default=None, const=None, nargs="?",
        choices=list(MODELS.keys()),
        help=(
            "model version to use - do not use with --from-pretrained, as we "
            "use the pretrained model"
        ),
    )
    parser.add_argument(
        "--half", default=False, action=boolean_action,
        help="bfloat16 compute with float32 parameters",
    )
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    parser.add_argument("--note", type=str, default=None,
                        help="note for the run (e.g. 'run on a TI-82')")
    parser.add_argument("--name", type=str, default=None,
                        help="name for the run (e.g. 'ti-82_run')")
    parser.add_argument(
        "--tags", type=str, nargs="*", default=None,
        help="tags for the run (e.g. '--tags test fine-tune')",
    )
    parser.add_argument(
        "--wandb-entity", type=str, default=os.getenv("WANDB_ENTITY"),
        help="wandb entity - defaults to the environment variable WANDB_ENTITY",
    )
    parser.add_argument(
        "--wandb-project", type=str, default=os.getenv("WANDB_PROJECT"),
        help="wandb project - defaults to the environment variable WANDB_PROJECT",
    )
    parser.add_argument(
        "--wandb", default=True, action=boolean_action,
        help="log to wandb when available (--no-wandb for local-only JSONL logs)",
    )
    parser.add_argument(
        "--resume", default=False, action=boolean_action,
        help=(
            "with --from-pretrained <run_dir>/latest.ckpt: continue an "
            "interrupted run exactly where it stopped - epoch counter, "
            "best-val-loss watermark, AdamW moments and LR schedule all "
            "carry over, and BatchNorm keeps training (unlike a plain "
            "--from-pretrained fine-tune). Pairs with the trainer's "
            "SIGTERM handler, which checkpoints latest.ckpt on preemption"
        ),
    )
    parser.add_argument(
        "--resume-optimizer", default=False, action=boolean_action,
        help=(
            "with --from-pretrained: restore the saved AdamW optimizer "
            "state from a .ckpt for an exact resume (the reference restores "
            "model weights only)"
        ),
    )
    parser.add_argument(
        "--profile-steps", type=uint, default=0,
        help=(
            "capture a torch.profiler trace of this many early train steps "
            "into <run_dir>/profile (0 disables)"
        ),
    )
    parser.add_argument(
        "--remat", choices=("none", "blocks", "full"), default="none",
        help=(
            "activation rematerialization for the backward pass (extension; "
            "trades recompute for activation memory - lets wide models/large "
            "batches fit: 'blocks' keeps only block-boundary activations, "
            "'full' recomputes the whole forward)"
        ),
    )
    parser.add_argument(
        "--spatial-parallel", type=positive_int, default=1,
        help=(
            "split each image's rows over N devices for the training steps "
            "and validation: N cards (each rank's own N under torchrun), or N "
            "handles to the CPU with --device cpu; halo rows are exchanged "
            "between the shards and BatchNorm takes its statistics over all "
            "of them; the image height must divide by N; the final test pass "
            "runs unsplit (default: 1)"
        ),
    )
    parser.add_argument(
        "--fsdp", action="store_true",
        help=(
            "under torchrun, shard the parameters of >= 4096 elements and "
            "their AdamW moments over the ranks (FSDP2; extension of the "
            "JAX package); a checkpoint holds the whole state"
        ),
    )
    parser.add_argument(
        "--checkpoint-interval", type=positive_int, default=1,
        metavar="N",
        help=(
            "write latest.ckpt every N epochs instead of every epoch "
            "(extension): on large models with short epochs the per-epoch "
            "state fetch + write can dominate wall time; preemption "
            "recovery then replays at most N-1 epochs (default: 1)"
        ),
    )
    parser.add_argument(
        "--packed-cache", nargs="?", const=True, default=None,
        metavar="DIR",
        help=(
            "decode-once packed image cache (extension): the first epoch "
            "decodes + resizes every image into uint8 memmap shards "
            "(content-hash keyed, invalidated when sources change); later "
            "epochs read at page-cache speed instead of re-decoding PNGs. "
            "Optional DIR sets the cache root (default: $YOGO_CACHE_DIR "
            "or ~/.cache/yogo_tpu_torch/packed)"
        ),
    )
    parser.add_argument(
        "--accumulate-grad-batches", type=positive_int, default=1,
        help=(
            "accumulate gradients over N loader batches before each "
            "optimizer step (extension; effective batch = N x batch-size "
            "at the activation memory of ONE batch - count-weighted, so "
            "it equals the big-batch gradient exactly under frozen BN; "
            "the LR schedule ticks per optimizer step) (default: 1)"
        ),
    )
    parser.add_argument(
        "--fast-eval", action=boolean_action, default=True,
        help=(
            "accumulate the post-training test metrics on device "
            "(extension; the default - see `test --fast-eval`). "
            "--no-fast-eval restores the host-exact "
            "Hungarian engine"
        ),
    )
    _add_fast_eval_capacity_args(parser)
    return parser


def test_parser(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(
            description="test on image data", allow_abbrev=False
        )
    parser.add_argument("ckpt_path", type=Path,
                        help="path to a .ckpt checkpoint")
    parser.add_argument("dataset_defn_path", type=Path)
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    parser.add_argument(
        "--wandb", action=boolean_action, default=False,
        help=(
            "log to wandb - this will create a new run. If neither this nor "
            "--wandb-resume-id are provided, the run is saved locally only"
        ),
    )
    parser.add_argument(
        "--wandb-entity", type=str, default=os.getenv("WANDB_ENTITY"),
        help="wandb entity - defaults to the environment variable WANDB_ENTITY",
    )
    parser.add_argument(
        "--wandb-project", type=str, default=os.getenv("WANDB_PROJECT"),
        help="wandb project - defaults to the environment variable WANDB_PROJECT",
    )
    parser.add_argument(
        "--wandb-resume-id", type=str, default=None,
        help="wandb run id to append results to",
    )
    parser.add_argument(
        "--dump-to-disk", action=boolean_action, default=False,
        help="dump results to disk as a pkl file",
    )
    parser.add_argument(
        "--include-mAP", action=boolean_action, default=False,
        help="calculate mAP as well - just a bit slower",
    )
    parser.add_argument(
        "--include-background", action=boolean_action, default=False,
        help="include 'background' in confusion matrix",
    )
    parser.add_argument(
        "--quantize", action=boolean_action, default=False,
        help=(
            "evaluate the int8 quantized inference path (the `infer "
            "--quantize` program, calibrated on the first test batch)"
        ),
    )
    parser.add_argument(
        "--packed-cache", nargs="?", const=True, default=None,
        metavar="DIR",
        help=(
            "decode-once packed image cache (extension; see `yogo train "
            "--help`) - repeated evaluations over the same dataset skip "
            "the per-run PNG decode"
        ),
    )
    parser.add_argument(
        "--fast-eval", action=boolean_action, default=True,
        help=(
            "accumulate metrics on device (extension; the default): "
            "greedy-matched, fixed-capacity accumulation instead of "
            "per-image host Hungarian matching, with no prediction tensor "
            "fetched to the host. Integer counters "
            "(precision/recall/confusion) are exact; mAP scores are "
            "binned to 1/4096 and matching is greedy max-IoU, which can "
            "differ from Hungarian only when detections COMPETE for "
            "overlapping ground truths. --no-fast-eval restores the "
            "host-exact Hungarian engine"
        ),
    )
    _add_fast_eval_capacity_args(parser)
    parser.add_argument("--note", type=str, default=None,
                        help="note for the run")
    parser.add_argument("--tags", type=str, nargs="*", default=None,
                        help="tags for the run")
    return parser


def export_parser(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(
            description="export a trained model", allow_abbrev=False
        )
    parser.add_argument("input", type=str,
                        help="path to input checkpoint (.ckpt or .pth)")
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    parser.add_argument(
        "--crop-height", type=unitary_float,
        help=(
            "crop image vertically - '--crop-height 0.25' crops images to "
            "(round(0.25 * height), width)"
        ),
    )
    parser.add_argument("--output-filename", type=str, help="output filename")
    parser.add_argument(
        "--simplify", action=boolean_action, default=True,
        help="attempt to simplify the onnx model",
    )
    parser.add_argument(
        "--format", type=str, default="onnx",
        choices=["onnx", "stablehlo", "pth"],
        help=(
            "export format (default: onnx; stablehlo is written by the JAX "
            "package, `python -m yogo_tpu export`, and raises here)"
        ),
    )
    return parser


def infer_parser(parser=None):
    from yogo_tpu_torch.ops.postprocess import INFER_COUNT_MAX_DETECTIONS

    if parser is None:
        parser = argparse.ArgumentParser(
            description="infer on image data", allow_abbrev=False
        )
    parser.add_argument("ckpt_path", type=Path,
                        help="path to checkpoint (.ckpt or .pth) defining the model")
    data_source = parser.add_mutually_exclusive_group(required=True)
    data_source.add_argument(
        "--path-to-images", "--path-to-image", type=Path, default=None,
        help="path to image or images",
    )
    data_source.add_argument(
        "--path-to-zarr", type=Path, default=None,
        help="path to zarr file (needs the zarr package)",
    )
    parser.add_argument(
        "--draw-boxes", action=boolean_action, default=False,
        help="plot and either save (if --output-dir is set) or show each image",
    )
    parser.add_argument(
        "--save-preds", action=boolean_action, default=False,
        help="save predictions in YOGO label format - requires --output-dir",
    )
    parser.add_argument(
        "--save-npy", action=boolean_action, default=False,
        help=(
            "Parse and save predictions in the same format as on scope - "
            "requires --output-dir"
        ),
    )
    parser.add_argument(
        "--count", action=boolean_action, default=False,
        help="display the final predicted counts per-class",
    )
    parser.add_argument(
        "--output-dir", type=Path, default=None,
        help="path to directory for results",
    )
    parser.add_argument(
        "--class-names", type=str, nargs="*", default=None,
        help="list of class names - will default to integers if not provided",
    )
    parser.add_argument(
        "--batch-size", type=positive_int, default=64,
        help="batch size for inference (default: 64)",
    )
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    parser.add_argument(
        "--half", action=boolean_action, default=False,
        help="bfloat16 inference (block 0 runs as the fused stem kernel)",
    )
    parser.add_argument(
        "--quantize", default=False, action=boolean_action,
        help=(
            "int8 inference: blocks with >= 128 input channels run s8 x s8 -> "
            "s32 convs, calibrated on the run's first batch"
        ),
    )
    parser.add_argument(
        "--crop-height", type=unitary_float,
        help=(
            "crop image vertically - '--crop-height 0.25' crops images to "
            "(round(0.25 * height), width)"
        ),
    )
    parser.add_argument(
        "--output-img-filetype", type=str,
        choices=[".png", ".tif", ".tiff"], default=".png",
        help="filetype for output images (default: .png)",
    )
    parser.add_argument(
        "--obj-thresh", type=unsigned_float, default=0.5,
        help="objectness threshold for predictions (default: 0.5)",
    )
    parser.add_argument(
        "--iou-thresh", type=unsigned_float, default=0.5,
        help="intersection over union threshold for predictions (default: 0.5)",
    )
    parser.add_argument(
        "--min-class-confidence-threshold", type=unitary_float, default=0.0,
        help=(
            "minimum confidence for a class to be considered - i.e. the max "
            "confidence must be greater than this value (default: 0.0)"
        ),
    )
    parser.add_argument(
        "--max-detections", type=uint, default=INFER_COUNT_MAX_DETECTIONS,
        help=(
            "capacity of the on-device count path: top-K cells by "
            "objectness kept before NMS (extension - the reference's host "
            "NMS is uncapped) "
            f"(default: {INFER_COUNT_MAX_DETECTIONS})"
        ),
    )
    parser.add_argument(
        "--fetch-top-k", type=uint, default=512,
        help=(
            "device->host candidate capacity for the artifact paths "
            "(--save-npy/--save-preds/--draw-boxes): only the top-K cells "
            "by objectness are fetched per image (results stay exact - "
            "images the capacity can't prove complete fall back to a "
            "full-tensor fetch; same knob as serve). 0 always fetches full "
            "tensors (default: 512)"
        ),
    )
    # accepted-but-unused in the reference too (reference:
    # yogo/utils/argparsers.py:478 is its only occurrence)
    parser.add_argument(
        "--heatmap-mask-path", type=Path, default=None,
        help="path to heatmap mask for the run (default: None)",
    )
    parser.add_argument(
        "--data-parallel", action="store_true",
        help="under torchrun, split the images over the ranks (rank 0 prints "
             "the summed counts); in one process that sees one device, the "
             "single-device path; one process that sees several cards "
             "raises (launch one process a card with torchrun)",
    )
    parser.add_argument(
        "--spatial-parallel", type=positive_int, default=1,
        help="split each image's rows over N devices: N cards (each rank's own "
             "N under torchrun, with --data-parallel), or N handles to the CPU "
             "with --device cpu; the image height must divide by N (default: 1)",
    )
    parser.add_argument(
        "--use-tqdm", action=boolean_action, default=True,
        help="use tqdm progress bar",
    )
    return parser


def serve_parser(parser=None):
    """`serve` (extension - the reference has no serving daemon): an HTTP
    inference server with micro-batching over one loaded model
    (yogo_tpu_torch/serve.py)."""
    if parser is None:
        parser = argparse.ArgumentParser(
            description="serve a model over HTTP", allow_abbrev=False
        )
    parser.add_argument("ckpt_path", type=Path,
                        help="path to checkpoint (.ckpt or .pth) defining the model")
    parser.add_argument(
        "--host", type=str, default="127.0.0.1",
        help="bind address (default: 127.0.0.1; 0.0.0.0 for external)",
    )
    parser.add_argument(
        "--port", type=uint, default=8765,
        help="bind port; 0 picks a free port (default: 8765)",
    )
    parser.add_argument(
        "--batch-size", type=positive_int, default=8,
        help=(
            "micro-batch capacity: concurrent requests coalesce into one "
            "device dispatch of this fixed shape (default: 8)"
        ),
    )
    parser.add_argument(
        "--linger-ms", type=unsigned_float, default=5.0,
        help=(
            "max time a request waits for batch-mates before dispatching "
            "(latency/throughput knob) (default: 5.0)"
        ),
    )
    parser.add_argument(
        "--fetch-top-k", type=positive_int, default=512,
        help=(
            "device->host candidate capacity: only the top-K cells by "
            "objectness are fetched per image (responses stay exact - a "
            "request whose threshold the capacity can't prove complete "
            "falls back to fetching that image's full tensor; see "
            "/metrics full_fetch_fallbacks) (default: 512)"
        ),
    )
    parser.add_argument(
        "--pipeline-depth", type=positive_int, default=2,
        help=(
            "max dispatched-but-unfetched micro-batches: the batcher "
            "assembles and uploads batch N+1 while batch N computes "
            "(each in-flight batch holds one input + one prediction "
            "tensor in device memory; 1 disables pipelining) (default: 2)"
        ),
    )
    parser.add_argument(
        "--max-queue", type=uint, default=None,
        help=(
            "load shedding: max images waiting for a dispatch slot before "
            "new requests get 503 + Retry-After (each queued frame holds "
            "H*W bytes of host memory; 0 disables shedding) "
            "(default: 8 * batch size)"
        ),
    )
    parser.add_argument(
        "--max-frames-per-request", type=uint, default=None,
        help=(
            "cap on N for raw octet-stream BATCH requests (body = N "
            "concatenated frames -> one HTTP round trip; also bounds the "
            "raw path's body size) (default: 4 * batch size)"
        ),
    )
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)
    parser.add_argument(
        "--half", default=False, action=boolean_action,
        help="bfloat16 inference (block 0 runs as the fused stem kernel)",
    )
    parser.add_argument(
        "--quantize", default=False, action=boolean_action,
        help="int8 serving (needs --calibration-images for models with int8 blocks)",
    )
    parser.add_argument(
        "--calibration-images", type=Path, default=None,
        help=(
            "directory of representative images to calibrate --quantize on "
            "(up to max(batch size, 8) of them; kept for hot reloads)"
        ),
    )
    parser.add_argument(
        "--crop-height", type=unitary_float,
        help=(
            "crop incoming images vertically - '--crop-height 0.25' crops "
            "to (round(0.25 * height), width) and resizes the model grid"
        ),
    )
    parser.add_argument(
        "--class-names", type=str, nargs="*", default=None,
        help="list of class names - will default to the checkpoint's",
    )
    parser.add_argument(
        "--obj-thresh", type=unsigned_float, default=0.5,
        help="default objectness threshold (per-request override via "
             "?obj_thresh=) (default: 0.5)",
    )
    parser.add_argument(
        "--iou-thresh", type=unsigned_float, default=0.5,
        help="default NMS IoU threshold (per-request override via "
             "?iou_thresh=) (default: 0.5)",
    )
    parser.add_argument(
        "--min-class-confidence-threshold", type=unitary_float, default=0.0,
        help="default minimum class confidence (per-request override) "
             "(default: 0.0)",
    )
    parser.add_argument(
        "--data-parallel", action="store_true",
        help="one replica a group of --spatial-parallel devices over every "
             "visible device, each micro-batch split over them (the batch "
             "size rounded up to a multiple of the replica count); one "
             "visible device serves alone",
    )
    parser.add_argument(
        "--spatial-parallel", type=positive_int, default=1,
        help="split each frame's rows over N devices (exactly N cards, or N "
             "handles to the CPU with --device cpu); the image height must "
             "divide by N (default: 1)",
    )
    return parser
