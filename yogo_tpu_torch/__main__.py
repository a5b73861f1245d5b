"""CLI: `python -m yogo_tpu_torch infer CKPT --path-to-images DIR --count
[--half] [--batch-size N] [--device cuda|cpu]` (port of the `infer --count`
part of yogo_tpu/__main__.py and yogo_tpu/utils/argparsers.py)."""

from __future__ import annotations

import argparse
from pathlib import Path


def _positive_int(val: str) -> int:
    v = int(val)
    if v < 1:
        raise argparse.ArgumentTypeError(f"{val} is not a positive integer")
    return v


def global_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m yogo_tpu_torch", allow_abbrev=False)
    sub = p.add_subparsers(dest="task", required=True)
    inf = sub.add_parser("infer", help="infer images using a model", allow_abbrev=False)
    inf.add_argument("ckpt_path", type=Path, help="path to a .ckpt checkpoint")
    inf.add_argument("--path-to-images", "--path-to-image", type=Path, required=True,
                     help="path to a .png image or a directory of them")
    inf.add_argument("--count", action=argparse.BooleanOptionalAction, default=False,
                     help="display the final predicted counts per-class")
    inf.add_argument("--batch-size", type=_positive_int, default=64,
                     help="batch size for inference (default: 64)")
    inf.add_argument("--device", type=str, default=None,
                     help="torch device (default: cuda; 'cpu' runs on the CPU)")
    inf.add_argument("--half", action=argparse.BooleanOptionalAction, default=False,
                     help="bfloat16 inference (block 0 runs as the fused stem kernel)")
    return p


def main(argv=None) -> None:
    p = global_parser()
    args = p.parse_args(argv)
    if not args.count:
        p.error("infer: only --count is ported so far")
    from yogo_tpu_torch.infer import predict

    predict(
        args.ckpt_path,
        path_to_images=args.path_to_images,
        count_predictions=True,
        batch_size=args.batch_size,
        half=args.half,
        device=args.device,
    )


if __name__ == "__main__":
    main()
