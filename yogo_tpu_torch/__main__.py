"""CLI dispatcher: `python -m yogo_tpu_torch {train,test,export,infer,serve}` (port of
yogo_tpu/__main__.py; subcommand modules import lazily). Every subcommand
runs on CUDA and raises without it, unless `--device cpu` is given."""

from __future__ import annotations

import sys

from yogo_tpu_torch.utils.argparsers import global_parser


def main(argv=None) -> None:
    p = global_parser()
    args = p.parse_args(argv)

    if args.task == "train":
        from yogo_tpu_torch.train import do_training

        do_training(args)
    elif args.task == "test":
        from yogo_tpu_torch.utils.test_model import do_model_test

        do_model_test(args)
    elif args.task == "export":
        from yogo_tpu_torch.utils.export_model import do_export

        try:
            do_export(args)
        except ImportError as e:
            print(f"export dependencies missing: {e}")
            sys.exit(1)
    elif args.task == "infer":
        from yogo_tpu_torch.infer import do_infer

        do_infer(args)
    elif args.task == "serve":
        from yogo_tpu_torch.serve import do_serve

        do_serve(args)
    else:
        p.print_help()


if __name__ == "__main__":
    main()
