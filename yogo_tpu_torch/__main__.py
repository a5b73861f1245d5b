"""CLI dispatcher: `python -m yogo_tpu_torch {train,test,infer}` (port of
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
    else:
        p.print_help()


if __name__ == "__main__":
    main()
