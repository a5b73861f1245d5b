"""CLI dispatcher: `python -m yogo_tpu_torch {train,test,infer,serve}` (port of
yogo_tpu/__main__.py; subcommand modules import lazily). Every subcommand
runs on CUDA and raises without it, unless `--device cpu` is given."""

from __future__ import annotations

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
