"""Small versions of the cells for the CPU tests: the same code paths at
96x128 (the half_filters checkpoint of tests/goldens stands in for the
base_model one, whose frames are 772x1032)."""

from __future__ import annotations

import copy

from yogo_bench import manifest

SEED = 98765432101


def base_model() -> dict:
    cfg = manifest.config(manifest.load(), "base_model")
    blocks = copy.deepcopy(cfg["blocks"])
    for b in blocks[:-1]:
        b["out"] //= 2
    return {"img_size": [96, 128], "checkpoint": str(manifest.ROOT / "tests/goldens/trained_half_filters.ckpt"),
            "architecture": "half_filters", "anchor_w": 0.1, "anchor_h": 0.12, "blocks": blocks}


def resize(workload: str) -> dict:
    """The `resize` of run.run_cell that shrinks `workload`."""
    if workload == "base_model.count":
        return {"config": base_model(), "traffic": {"batch": 4, "pool": 8, "blobs": [2, 5], "warmup_batches": 1}}
    if workload == "convnext_small.count":
        return {"config": {"img_size": [96, 128]},
                "traffic": {"batch": 2, "pool": 4, "blobs": [2, 5], "warmup_batches": 1}}
    if workload == "base_model.train":
        return {"config": {"img_size": [96, 128]},
                "traffic": {"batch": 4, "pool": 12, "blobs": [2, 5], "check_within": 4}}
    raise KeyError(workload)
