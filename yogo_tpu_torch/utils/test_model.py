"""Standalone `test` entry: evaluate a checkpoint on a dataset definition's
test split (port of yogo_tpu/utils/test_model.py; reference:
yogo/utils/test_model.py:23-117). Runs on CUDA unless --device says
otherwise."""

from __future__ import annotations

import pickle
from typing import Any, Dict

import torch

from yogo_tpu_torch.data.definition import DatasetDefinition
from yogo_tpu_torch.data.loader import get_dataloader
from yogo_tpu_torch.train import Trainer
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.logging import RunLogger

TEST_SEED = 111111  # reference: yogo/utils/test_model.py:85


def test_model(args):
    """Run the test pass, print and log it; returns the metric tuple of
    Trainer.test (None for an empty test loader)."""
    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.parallel.distributed import local_device, process_shard

    # no card and no --device cpu: refuse before anything is read. Under
    # torchrun each rank scores its shard of the test split: the device
    # engine's state is summed over the ranks, the host engine's is the
    # rank's own (as the JAX package's and the reference's rank-0 test)
    rank, world = process_shard()
    device_arg = getattr(args, "device", None)
    device = local_device(device_arg) if world > 1 else resolve_device(device_arg)
    model, variables, cfg = load_any(args.ckpt_path)
    # the reference evaluates under fp16 autocast (yogo/utils/test_model.py:37);
    # here, as in the JAX package, that is bf16 compute
    model = model.with_compute_dtype(torch.bfloat16)
    data_defn = DatasetDefinition.from_yaml(args.dataset_defn_path)

    # fail fast on a class-count mismatch: the reference silently builds
    # metrics from the dataset's classes (yogo/utils/test_model.py:32-34)
    # and a 2-class checkpoint on a 1-class dataset dies as an opaque
    # broadcast error deep inside the metrics engine
    if int(model.num_classes) != len(data_defn.classes):
        raise ValueError(
            f"checkpoint predicts {int(model.num_classes)} classes but the "
            f"dataset definition lists {len(data_defn.classes)} "
            f"({data_defn.classes}) - evaluate against the dataset the "
            "model was trained for"
        )

    config: Dict[str, Any] = {
        "class_names": data_defn.classes,
        "no_classify": False,
        "iou_weight": 1,
        "no_obj_weight": 0.5,
        "label_smoothing": 0.0001,
        "half": True,
        "model": str(args.ckpt_path),
        "test_set": str(args.dataset_defn_path),
    }

    Sx, Sy = model.grid
    loaders = get_dataloader(
        data_defn,
        64,
        Sx=Sx,
        Sy=Sy,
        image_hw=tuple(int(d) for d in model.img_size),
        rgb=bool(model.is_rgb),  # RGB checkpoints need 3-channel batches
        normalize_images=bool(cfg.get("normalize_images", model.normalize_images)),
        shard=(rank, world),
        packed_cache=getattr(args, "packed_cache", None),
    )
    if "test" not in loaders:
        raise ValueError(
            "dataset definition has no test split - add test_paths or a "
            "'test' split fraction"
        )
    test_loader = loaders["test"]
    # NOTE: the reference seeds its test DataLoader's generator with 111111
    # (yogo/utils/test_model.py:85), but with shuffle off the seed never
    # influences iteration order there or here - our test loader iterates
    # deterministically in dataset order, so no assignment is needed.

    metrics = Trainer.test(
        test_loader,
        config,
        model,
        variables,
        include_mAP=args.include_mAP,
        include_background=args.include_background,
        quantize=getattr(args, "quantize", False),
        fast_eval=getattr(args, "fast_eval", False),
        fast_eval_max_detections=getattr(
            args, "fast_eval_max_detections", 256
        ),
        fast_eval_max_labels=getattr(args, "fast_eval_max_labels", 256),
        device=device,
    )

    if rank != 0:
        return metrics
    log_to_wandb = args.wandb or (args.wandb_resume_id is not None)
    logger = RunLogger(
        log_dir=None,
        config=config,
        use_wandb=log_to_wandb,
        wandb_entity=args.wandb_entity,
        wandb_project=args.wandb_project,
        # the reference appends this tag to every test-time run
        # (yogo/utils/test_model.py:64)
        tags=list(args.tags or []) + ["resumed for test"],
        notes=args.note,
        wandb_resume_id=args.wandb_resume_id,
    )
    if metrics is not None:
        (
            mean_loss,
            mAP,
            confusion,
            accuracy,
            roc,
            precision,
            recall,
            calibration_error,
            missed,
            extra,
            total_true,
            class_names,
        ) = metrics
        print(f"test loss: {mean_loss:.5f}")
        print(f"test mAP: {mAP.get('map'):.5f}" if args.include_mAP else "mAP: skipped")
        print("per-class precision:", dict(zip(class_names, precision.round(4))))
        print("per-class recall:   ", dict(zip(class_names, recall.round(4))))
        print(f"calibration error (ECE): {calibration_error:.5f}")
        print("confusion matrix:\n", confusion)
        print("missed by class:", missed.tolist(), "extra by class:", extra.tolist())
        logger.summary(
            {
                "test loss": mean_loss,
                "test mAP": mAP.get("map"),
                "calibration error": calibration_error,
                # archived metric files record which engine scored them
                # (fast-eval device greedy vs reference-exact Hungarian)
                "eval engine": (
                    "device-fast-eval"
                    if getattr(args, "fast_eval", False)
                    else "host-hungarian"
                ),
            }
        )
    logger.finish()

    if args.dump_to_disk:
        with open("test_metrics.pkl", "wb") as f:
            pickle.dump(metrics, f)
    return metrics


def do_model_test(args):
    return test_model(args)
