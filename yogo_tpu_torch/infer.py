"""Inference driver: `python -m yogo_tpu_torch infer` and predict()
(port of yogo_tpu/infer.py).

  - fixed-shape batches: the ragged last batch is padded by repeating its
    first image, and the padding is masked out;
  - `--count` alone runs selection-first on the device: forward to the
    undecoded head, then filter -> top-K -> survivor decode -> NMS -> count,
    and only the (C,) counts come back;
  - the artifact paths (`--save-preds`, `--save-npy`, `--draw-boxes`, and
    the host count that rides with them) fetch the top `fetch_top_k` cells
    by objectness of each image and run the host formatter on them; an image
    whose K-th candidate passes the lowest consumer threshold fetches its
    full decoded slice instead, so the artifacts are those of the full
    tensor, bit for bit; `fetch_top_k=0` and return_full_predictions fetch
    the full decoded tensor;
  - a one-thread prefetcher decodes the next batch while this one computes;
  - `--data-parallel` under torchrun (a process group of N > 1 ranks): rank
    p takes the p-th contiguous chunk of the sorted image list, every rank
    runs as many batch rounds (fully masked ones where its chunk is
    shorter), the counts are summed over the ranks and printed by rank 0,
    and each rank writes the artifacts of its own images (the .npy as
    `<name>.p<rank>.npy`, image ids global). In one process that sees one
    device it is the single-device path, as the JAX package with one
    device builds no mesh; one process that sees several cards raises
    (the port runs one process a card, where JAX meshes them);
  - `--spatial-parallel N` splits each image's rows over N devices
    (parallel/spatial.py: halo rows copied between the shards, the stem
    and int8 conv kernels launched once a shard): N cards of one process,
    N handles to the CPU with `--device cpu`, or each rank's own N cards
    under torchrun with `--data-parallel`; the head is gathered to the
    first device and everything after the forward runs as on one device.

Output artifacts keep the reference schemas: YOLO-format txt prediction
files, the scope (8+C, N) .npy array with its JSON sidecar, drawn images and
per-class counts. The per-batch work lives in `Predictor`, which other
callers (serve.py, chip_smoke.py) call directly with arrays.
"""

from __future__ import annotations

import datetime
import json
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Literal, Optional, Sequence, Union

import numpy as np
import torch

from yogo_tpu_torch.data.image_source import get_dataset
from yogo_tpu_torch.data.loader import choose_dataloader_num_workers
from torch import nn

from yogo_tpu_torch.models.yogo import YOGO, resolve_device
from yogo_tpu_torch.ops.quant import (
    family_quant_forward,
    family_quant_plan,
    quant_program_of_rank0,
)
from yogo_tpu_torch.ops.postprocess import (
    INFER_COUNT_MAX_DETECTIONS,
    count_cells_for_formatted_preds,
    count_class_predictions_raw,
    decode_raw_slice,
    format_preds,
    format_to_numpy,
    scatter_candidates,
    select_top_candidates_raw,
)
from yogo_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    collective_device,
    local_device,
    process_shard,
)
from yogo_tpu_torch.parallel.mesh import as_device, device_grid, replicate
from yogo_tpu_torch.parallel.spatial import RowSplit
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.tracing import span
from yogo_tpu_torch.utils.weights import state_dict_from_flax


def load_model(
    path_to_ckpt: Union[str, Path],
    *,
    half: bool = False,
    device=None,
    channels_last: bool = True,
    vertical_crop_height: Optional[float] = None,
):
    """A .ckpt or .pth -> (model config, the architecture's module on
    `device` (default CUDA) in eval mode, meta). `half` computes in bf16, which runs block 0
    as the fused stem kernel on uint8 input; `vertical_crop_height` resizes
    the model's grid to round(fraction * height) rows (the fully
    convolutional crop of yogo/model.py:236-265)."""
    model, variables, meta = load_any(path_to_ckpt)
    if half:
        model = model.with_compute_dtype(torch.bfloat16)
    if vertical_crop_height:
        model = model.resize(int(round(vertical_crop_height * model.img_size[0])))
    stack = model.module(device, channels_last=channels_last)
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model, stack, meta


class Predictor:
    """A loaded model and the per-batch steps of predict():
    `forward_raw` (uint8 batch -> NHWC head), `count` (head + image mask ->
    per-class counts on the device), `forward` (decoded predictions) and
    the candidate fetch (`candidates`, `decode_slice`). With `qp` (the int8
    program of the family's ops/quant.family_quant_plan, on the module's
    device) both forwards run the family's quantized forward, whose head
    is f32.

    `devices` (N > 1 entries, the first the module's) splits each image's
    rows over them (parallel/spatial.py): the stack and `qp` are copied to
    the other devices, the forwards run row-split and leave the head on the
    first device, where every other step runs unchanged."""

    def __init__(
        self,
        model: YOGO,
        stack: nn.Module,
        *,
        obj_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        min_class_confidence_threshold: float = 0.0,
        max_detections: int = INFER_COUNT_MAX_DETECTIONS,
        meta: Optional[dict] = None,
        qp: Optional[dict] = None,
        devices: Optional[Sequence] = None,
    ):
        self.model = model
        self.meta = meta or {}
        self.stack = stack
        self.device = next(stack.parameters()).device
        self.devices = [as_device(d) for d in devices] if devices else [self.device]
        if self.devices[0] != self.device:
            raise ValueError(f"the module is on {self.device}, the first row shard on {self.devices[0]}")
        self.rows = RowSplit(model, self.devices) if len(self.devices) > 1 else None
        self.qp = qp
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.min_class_confidence_threshold = min_class_confidence_threshold
        self.max_detections = max_detections

    @property
    def qp(self) -> Optional[dict]:
        return self._qp

    @qp.setter
    def qp(self, qp: Optional[dict]) -> None:
        """Set the int8 program (None: the float stack); row-split, every
        shard's device gets its copy of the stack and program now."""
        self._qp = qp
        if self.rows is not None:
            copies = {}
            for d in self.devices:
                if d not in copies:
                    copies[d] = replicate(self.stack, qp, d)
            self.shard_weights = [copies[d] for d in self.devices]

    @classmethod
    def from_checkpoint(
        cls,
        path_to_ckpt: Union[str, Path],
        *,
        half: bool = False,
        device=None,
        channels_last: bool = True,
        vertical_crop_height: Optional[float] = None,
        quantize: bool = False,
        calib=(),
        devices: Optional[Sequence] = None,
        **thresholds,
    ) -> "Predictor":
        """Load a .ckpt or .pth onto `device` (default CUDA; with `devices`,
        their first), as load_model. quantize=True builds the int8 program,
        calibrated on `calib` (a list of NCHW batches; unused when the
        program holds no int8 conv) with the unsplit forward on that device,
        then copied to the others."""
        if devices:
            device = devices[0]
        model, stack, meta = load_model(
            path_to_ckpt, half=half, device=device, channels_last=channels_last,
            vertical_crop_height=vertical_crop_height,
        )
        if devices:
            RowSplit(model, devices)  # refuse a height that does not split before calibrating
        qp = quantize_stack(model, stack, calib) if quantize else None
        return cls(model, stack, meta=meta, qp=qp, devices=devices, **thresholds)

    def to_device(self, imgs) -> torch.Tensor:
        """(B, C, H, W) numpy or tensor -> tensor on the model's device (the
        span "to_device" where a copy happens)."""
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        if imgs.device == self.device:
            return imgs
        with span("to_device"):
            return imgs.to(self.device, non_blocking=True)

    def forward_raw(self, imgs) -> torch.Tensor:
        """(B, C, H, W) batch -> undecoded NHWC head (B, Sy, Sx, 5+C)."""
        if self.rows is not None:
            return self.rows.forward_raw(self.shard_weights, self.to_device(imgs))
        if self.qp is not None:
            fwd = family_quant_forward(self.model)
            return fwd(self.model, self.qp, self.to_device(imgs), decode=False)
        return self.model.apply(self.stack, self.to_device(imgs), decode=False)

    def forward(self, imgs) -> torch.Tensor:
        """(B, C, H, W) batch -> decoded (B, 5+C, Sy, Sx) f32, class
        softmax applied."""
        if self.rows is not None:
            with torch.inference_mode():
                return self.model._decode_raw(self.forward_raw(imgs), inference=True)
        if self.qp is not None:
            fwd = family_quant_forward(self.model)
            return fwd(self.model, self.qp, self.to_device(imgs), inference=True)
        return self.model.apply(self.stack, self.to_device(imgs), inference=True)

    def count(self, raw: torch.Tensor, image_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Head -> (C,) per-class detection counts, on the device (the span
        "count", with the stream time of the head's device)."""
        m = self.model
        with span("count", raw.device):
            if image_mask is not None:
                image_mask = image_mask.to(raw.device)
            return count_class_predictions_raw(
                raw,
                m.anchor_w,
                m.anchor_h,
                width_multiplier=m.width_multiplier,
                height_multiplier=m.height_multiplier,
                obj_thresh=self.obj_thresh,
                iou_thresh=self.iou_thresh,
                min_class_confidence_threshold=self.min_class_confidence_threshold,
                max_detections=self.max_detections,
                image_mask=image_mask,
            )

    def candidates(self, raw: torch.Tensor, k: int):
        """Head -> the top-k cells of each image by objectness, decoded:
        (rows (B, k, 5+C) f32, flat cell indices (B, k)), on the device."""
        m = self.model
        return select_top_candidates_raw(
            raw, k, m.anchor_w, m.anchor_h,
            width_multiplier=m.width_multiplier, height_multiplier=m.height_multiplier,
        )

    def decode_slice(self, raw: torch.Tensor, slot) -> torch.Tensor:
        """Head -> image `slot`'s decoded (5+C, Sy, Sx) grid, on the device."""
        m = self.model
        return decode_raw_slice(
            raw, slot, m.anchor_w, m.anchor_h,
            width_multiplier=m.width_multiplier, height_multiplier=m.height_multiplier,
        )


def needs_calibration(model: YOGO) -> bool:
    """Whether the int8 program of this architecture holds an int8 conv,
    and so reads calibration images (a narrow one runs bf16 throughout)."""
    return not family_quant_plan(model, None)[3]


def quantize_stack(model: YOGO, stack: nn.Module, calib) -> dict:
    """The int8 program of a loaded stack, on the stack's device,
    calibrated on `calib` (a list of NCHW batches), which may be empty only
    when the program needs no calibration. In a process group rank 0
    calibrates on its `calib` and every rank runs its program (the other
    ranks' `calib` is not read)."""
    if needs_calibration(model) and not calib and process_shard()[0] == 0:
        raise ValueError("--quantize needs at least one image to calibrate")
    device = next(stack.parameters()).device
    build_qp, _, n_scales, _ = family_quant_plan(model, stack, device=device)
    return quant_program_of_rank0(build_qp, n_scales, calib, device)


def _refuse_several_cards(device) -> None:
    """--data-parallel without a process group, on the cards: refused where
    several are visible, since the port runs one process a card (torchrun)
    where the JAX package meshes every local device."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(
            f"--data-parallel in one process that sees {n} cards would run on one of them; "
            f"launch one process a card: torchrun --nproc-per-node {n} -m yogo_tpu_torch "
            "infer ... --data-parallel"
        )


def save_predictions(fnames, batch_preds, obj_thresh=0.5, iou_thresh=0.5):
    """Write YOLO-format txt per image: 'class cx cy w h' rows
    (reference: yogo/infer.py:39-57)."""
    for fname, pred in zip(fnames, batch_preds):
        rows = format_preds(np.asarray(pred), obj_thresh=obj_thresh, iou_thresh=iou_thresh)
        lines = [f"{int(np.argmax(r[5:]))} {r[0]} {r[1]} {r[2]} {r[3]}" for r in rows]
        Path(fname).write_text("\n".join(lines))


def get_prediction_class_counts(
    batch_preds: np.ndarray,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
) -> np.ndarray:
    """Per-class counts of decoded (N, 5+C, Sy, Sx) predictions through the
    host formatter (reference: yogo/infer.py:60-87); the device path is
    Predictor.count."""
    total = np.zeros(batch_preds.shape[1] - 5, np.int64)
    for pred in batch_preds:
        rows = format_preds(
            pred,
            obj_thresh=obj_thresh,
            iou_thresh=iou_thresh,
            min_class_confidence_threshold=min_class_confidence_threshold,
        )
        if len(rows):
            total += count_cells_for_formatted_preds(rows[:, 5:])
    return total


def write_metadata(metadata_path: Path, **kwargs) -> None:
    with open(Path(metadata_path).with_suffix(".json"), "w") as f:
        json.dump(kwargs, f, indent=4)


def predict(
    path_to_ckpt: Union[str, Path],
    *,
    path_to_images: Optional[Path] = None,
    path_to_zarr: Optional[Path] = None,
    output_dir: Optional[str] = None,
    draw_boxes: bool = False,
    save_preds: bool = False,
    save_npy: bool = False,
    class_names: Optional[List[str]] = None,
    count_predictions: bool = False,
    batch_size: int = 64,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    vertical_crop_height: Optional[float] = None,
    use_tqdm: bool = False,
    output_img_ftype: Literal[".png", ".tif", ".tiff"] = ".png",
    requested_num_workers: Optional[int] = None,
    min_class_confidence_threshold: float = 0.0,
    half: bool = False,
    quantize: bool = False,
    return_full_predictions: bool = False,
    max_detections: int = INFER_COUNT_MAX_DETECTIONS,
    data_parallel: bool = False,
    spatial_parallel: int = 1,
    fetch_top_k: int = 512,
    device=None,
    devices: Optional[Sequence] = None,
) -> Optional[np.ndarray]:
    """Mirrors yogo_tpu.infer.predict (default device: the rank's card;
    device="cpu" runs on the CPU). Prints the per-class counts with
    count_predictions, writes the artifacts asked for, and returns
    (N, 5+C, Sy, Sx) f32 with return_full_predictions. `quantize` runs the
    int8 program (ops/quant.py), calibrated on the run's first batch_size
    images (rank 0's, under data_parallel in a process group: every rank
    runs its program). `data_parallel` splits the images over the ranks of
    the process group (see the module docstring); in one process that
    sees several cards it raises (one process a card: torchrun).
    `spatial_parallel` N > 1 splits each image's rows over N devices
    (parallel/spatial.py; parallel/mesh.device_grid picks them: N handles
    to the CPU with device="cpu", cards cuda:0..N-1, or a rank's own N
    cards under torchrun); `devices` names them explicitly (its first N,
    e.g. ["cuda:0"] * N)."""
    rank, world = process_shard()
    mh = data_parallel and world > 1
    if world > 1 and (data_parallel or spatial_parallel > 1):
        if not data_parallel:
            raise ValueError(
                "spatial_parallel-only inference is single-process; add "
                "data_parallel to shard images across processes too"
            )
        if return_full_predictions:
            raise ValueError(
                "return_full_predictions is single-process only (each "
                "process holds only its own images' predictions); use "
                "save_npy and merge the per-process .npy files"
            )
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if save_preds and draw_boxes:
        raise ValueError(
            "cannot save predictions in YOGO format and draw_boxes at the same time"
        )
    elif output_dir is not None and not (save_preds or draw_boxes or save_npy):
        warnings.warn(
            f"output dir is not None (is {output_dir}), but it will not be "
            "used since save_preds and draw_boxes are both false"
        )
    elif output_dir is not None:
        Path(output_dir).mkdir(exist_ok=True, parents=False)
    elif save_preds:
        raise ValueError("output_dir must not be None if save_preds is True")
    if output_img_ftype not in (".png", ".tif", ".tiff"):
        raise ValueError(
            "only .png, .tif, and .tiff are supported for output img "
            f"filetype; got {output_img_ftype}"
        )

    if data_parallel and world == 1 and devices is None:
        _refuse_several_cards(device)
    if spatial_parallel > 1 or devices:
        # this process's (or rank's) row shards: one group of N devices
        devices = device_grid(spatial_parallel, devices=devices, device=device)[0]
    if devices:
        device = as_device(devices[0])
    else:
        device = local_device(device) if world > 1 else resolve_device(device)
    pred = Predictor.from_checkpoint(
        path_to_ckpt, half=half, device=device, vertical_crop_height=vertical_crop_height,
        devices=devices, obj_thresh=obj_thresh, iou_thresh=iou_thresh,
        min_class_confidence_threshold=min_class_confidence_threshold,
        max_detections=max_detections,
    )
    model, meta = pred.model, pred.meta
    img_h, img_w = model.img_size
    crop_hw = (img_h, img_w) if vertical_crop_height else None
    num_classes = model.num_classes
    if class_names is not None and len(class_names) != num_classes:
        raise ValueError(f"expected {num_classes} class names, got {len(class_names)}")
    if class_names is None:
        class_names = meta.get("class_names") or meta.get("classes")
        if class_names is not None and len(class_names) != num_classes:
            # stale metadata: zipping short names with the counts would
            # silently drop classes from the --count output
            warnings.warn(
                f"checkpoint lists {len(class_names)} class names but the "
                f"model has {num_classes} classes; falling back to indices"
            )
            class_names = None

    dataset = get_dataset(
        path_to_images=path_to_images,
        path_to_zarr=path_to_zarr,
        crop_hw=crop_hw,
        normalize_images=bool(model.normalize_images),
        rgb=bool(model.is_rgb),
    )
    n_images = len(dataset)
    num_workers = choose_dataloader_num_workers(n_images, requested_num_workers=requested_num_workers)
    # rank p's contiguous chunk of the sorted image list (everything in
    # one process); clamped, so a rank past the end has an empty chunk
    per_rank = -(-n_images // world) if mh else n_images
    chunk_lo = min(n_images, rank * per_rank) if mh else 0
    chunk_hi = min(n_images, chunk_lo + per_rank)

    if quantize:
        if n_images == 0:
            raise ValueError("--quantize needs at least one image to calibrate")
        # calibrate on the run's own leading images, decoded once more by
        # the batch loop below (yogo_tpu/infer.py:311-350); a program with
        # no int8 conv decodes none, and neither does a rank other than 0
        calib = []
        if needs_calibration(model) and rank == 0:
            idxs = range(chunk_lo, min(chunk_lo + batch_size, chunk_hi))
            if num_workers > 0:
                with ThreadPoolExecutor(max_workers=num_workers) as pool:
                    items = list(pool.map(dataset.__getitem__, idxs))
            else:
                items = [dataset[i] for i in idxs]
            calib = [np.stack([im for im, _ in items])]
        pred.qp = quantize_stack(model, pred.stack, calib)

    sx, sy = model.grid
    pred_dim = 5 + num_classes
    needs_full = return_full_predictions or save_npy or save_preds or draw_boxes
    # every host consumer filters at an objectness threshold, so an image's
    # top-K candidates hold all it needs when the K-th candidate's
    # objectness is <= the LOWEST of them; others fetch their full slice
    consumer_threshes = []
    if draw_boxes or save_preds or count_predictions:
        consumer_threshes.append(obj_thresh)
    if save_npy:
        # format_to_numpy filters at format_preds' DEFAULT thresholds
        # (reference: yogo/utils/prediction_formatting.py:130-134)
        consumer_threshes.append(0.5)
    use_candidates = needs_full and not return_full_predictions and 0 < fetch_top_k < sx * sy
    thresh_floor = min(consumer_threshes, default=obj_thresh)
    n_full_fallbacks = 0

    results = (
        np.zeros((n_images, pred_dim, sy, sx), np.float32) if return_full_predictions else None
    )
    np_results: List[np.ndarray] = []
    tot_counts = torch.zeros(num_classes, dtype=torch.int64, device=device)
    host_counts = np.zeros(num_classes, np.int64)

    decode_pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None

    def zero_batch():
        # a fully masked round of a rank whose chunk is shorter
        ch = 3 if model.is_rgb else 1
        dtype = np.float32 if model.normalize_images else np.uint8
        return np.zeros((batch_size, ch, img_h, int(img_w)), dtype), [], 0

    def load_batch(start: int):
        idxs = range(start, min(start + batch_size, chunk_hi))
        if len(idxs) == 0:
            return zero_batch()
        if decode_pool is not None:
            items = list(decode_pool.map(dataset.__getitem__, idxs))
        else:
            items = [dataset[i] for i in idxs]
        imgs = np.stack([im for im, _ in items])
        real = len(items)
        if real < batch_size:  # pad to the fixed batch shape
            imgs = np.concatenate([imgs, np.repeat(imgs[:1], batch_size - real, axis=0)])
        return imgs, [name for _, name in items], real

    pbar = None
    if use_tqdm:
        try:
            from tqdm import tqdm

            pbar = tqdm(unit="images", total=chunk_hi - chunk_lo)
        except ImportError:
            pass

    if mh:
        # as many rounds on every rank (the JAX package's collective
        # alignment): a shorter chunk runs trailing fully masked batches
        n_rounds = -(-per_rank // batch_size) if n_images else 0
        starts = [chunk_lo + k * batch_size for k in range(n_rounds)]
    else:
        starts = list(range(0, n_images, batch_size))
    prefetcher = ThreadPoolExecutor(max_workers=1)
    try:
        pending = prefetcher.submit(load_batch, starts[0]) if starts else None
        for bi, start in enumerate(starts):
            # a malformed image skips its batch with a warning, as the
            # reference's loop does (reference: yogo/infer.py:299-309)
            try:
                imgs, names, real = pending.result()
            except Exception as e:
                warnings.warn(f"got error {e}; continuing")
                # a rank of a group keeps its round count: a masked batch
                imgs, names, real = zero_batch() if mh else (None, None, 0)
            pending = prefetcher.submit(load_batch, starts[bi + 1]) if bi + 1 < len(starts) else None
            if imgs is None:
                continue

            if count_predictions and not needs_full:
                mask = torch.arange(batch_size) < real
                tot_counts += pred.count(pred.forward_raw(imgs), mask)
                if pbar:
                    pbar.update(real)
                continue

            if use_candidates:
                raw = pred.forward_raw(imgs)
                rows, idx = pred.candidates(raw, fetch_top_k)
                rows_np, idx_np = rows.cpu().numpy(), idx.cpu().numpy()
                res = np.empty((real, pred_dim, sy, sx), np.float32)
                for j in range(real):
                    if float(rows_np[j, -1, 4]) > thresh_floor:
                        n_full_fallbacks += 1
                        res[j] = pred.decode_slice(raw, j).cpu().numpy()
                    else:
                        res[j] = scatter_candidates(rows_np[j], idx_np[j], pred_dim, sy, sx)
                del raw, rows, idx
            else:
                res = pred.forward(imgs).cpu().numpy()[:real]

            if draw_boxes:
                from yogo_tpu_torch.utils.drawing import draw_yogo_prediction

                for j in range(real):
                    bbox_img = draw_yogo_prediction(
                        img=imgs[j],
                        prediction=res[j],
                        obj_thresh=obj_thresh,
                        iou_thresh=iou_thresh,
                        min_class_confidence_threshold=min_class_confidence_threshold,
                        labels=class_names,
                        images_are_normalized=bool(model.normalize_images),
                    )
                    if output_dir is not None:
                        bbox_img.save(Path(output_dir) / Path(names[j]).with_suffix(output_img_ftype).name)
                    else:
                        bbox_img.show()
            if save_preds:
                out_fnames = [Path(output_dir) / Path(n).with_suffix(".txt").name for n in names]
                save_predictions(out_fnames, res, obj_thresh=obj_thresh, iou_thresh=iou_thresh)
            if save_npy:
                for j in range(real):
                    np_results.append(format_to_numpy(start + j, res[j], int(img_h), int(img_w)))
            if count_predictions:
                host_counts += get_prediction_class_counts(
                    res,
                    obj_thresh=obj_thresh,
                    iou_thresh=iou_thresh,
                    min_class_confidence_threshold=min_class_confidence_threshold,
                )
            if return_full_predictions:
                results[start : start + real] = res
            if pbar:
                pbar.update(real)
    finally:
        prefetcher.shutdown(wait=False)
        if decode_pool is not None:
            decode_pool.shutdown(wait=False)
        if pbar:
            pbar.close()

    if use_candidates and n_images and n_full_fallbacks > 0.1 * n_images:
        # exact all the same: a fallback costs only the full-slice fetch
        warnings.warn(
            f"{n_full_fallbacks}/{n_images} images exceeded the "
            f"--fetch-top-k {fetch_top_k} candidate capacity and fell back "
            "to full-tensor fetches (exact but slow); raise --fetch-top-k "
            "to cover your detection density"
        )

    if count_predictions:
        counts = torch.from_numpy(host_counts).to(device) if needs_full else tot_counts
        if mh:
            # each rank counted its own images
            counts = all_reduce_sum(counts.to(collective_device(counts.device)))
        if rank == 0 or not mh:
            print(list(zip(class_names or range(num_classes), map(int, counts.cpu().numpy()))))

    if save_npy and np_results:
        if path_to_images:
            filename = Path(path_to_images).resolve().parent.stem
        else:
            filename = Path(path_to_zarr).resolve().stem
        if mh:
            # one file a rank, of its own images (ids stay global):
            # concatenated they are the single-process file
            filename = f"{filename}.p{rank}"
        base = Path(output_dir).resolve() if output_dir else Path.cwd().resolve()
        fp = base / f"{filename}.npy"
        np.save(fp, np.hstack(np_results))
        write_metadata(
            fp.with_suffix(".json"),
            run_name=fp.with_suffix("").name,
            model_name=meta.get("model_name"),
            obj_thresh=obj_thresh,
            iou_thresh=iou_thresh,
            vertical_crop_height_px=int(img_h),
            write_date=datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        )
    return results


def do_infer(args) -> None:
    predict(
        args.ckpt_path,
        path_to_images=args.path_to_images,
        path_to_zarr=args.path_to_zarr,
        output_dir=args.output_dir,
        draw_boxes=args.draw_boxes,
        save_preds=args.save_preds,
        save_npy=args.save_npy,
        class_names=args.class_names,
        obj_thresh=args.obj_thresh,
        iou_thresh=args.iou_thresh,
        batch_size=args.batch_size,
        use_tqdm=args.use_tqdm,
        vertical_crop_height=args.crop_height,
        count_predictions=args.count,
        output_img_ftype=args.output_img_filetype,
        min_class_confidence_threshold=args.min_class_confidence_threshold,
        half=args.half,
        quantize=args.quantize,
        max_detections=args.max_detections,
        data_parallel=args.data_parallel,
        spatial_parallel=args.spatial_parallel,
        fetch_top_k=args.fetch_top_k,
        device=args.device,
    )
