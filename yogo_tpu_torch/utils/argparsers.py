"""CLI argument parsers (port of yogo_tpu/utils/argparsers.py, which is
flag-compatible with the reference CLI, reference:
yogo/utils/argparsers.py:74-489): `train`, `test` and `infer` with the same
flag names, validating types and defaults as the JAX package; `--device`
defaults to CUDA. `infer` holds the flags of the paths ported so far, and
`export` / `serve` are not ported yet.
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
    infer_parser(
        parser=subparsers.add_parser(
            "infer", help="infer images using a model", allow_abbrev=False
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
            "split each image's rows over N devices (extension of the JAX "
            "package; not ported yet: any N > 1 is refused) (default: 1)"
        ),
    )
    parser.add_argument(
        "--fsdp", action="store_true",
        help=(
            "shard params, optimizer moments, and batch stats over the "
            "devices (extension of the JAX package; not ported yet: the "
            "flag is refused)"
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
            "evaluate the int8 quantized inference path (extension of the "
            "JAX package; not ported yet: the flag is refused)"
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


def infer_parser(parser=None):
    """The flags of `infer` that are ported so far: the --count path."""
    if parser is None:
        parser = argparse.ArgumentParser(
            description="infer images using a model", allow_abbrev=False
        )
    parser.add_argument("ckpt_path", type=Path, help="path to a .ckpt checkpoint")
    parser.add_argument(
        "--path-to-images", "--path-to-image", type=Path, required=True,
        help="path to a .png image or a directory of them",
    )
    parser.add_argument(
        "--count", action=boolean_action, default=False,
        help="display the final predicted counts per-class",
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
    return parser
