"""The count driver: `yogo infer --count`'s per-batch path, as
yogo_tpu_torch.infer.predict runs it. Each batch of B uint8 frames is a
numpy array that a one-thread prefetcher assembles one batch ahead from a
pool of seeded golden-scene frames (a gather into a reused host buffer);
the main thread then calls `Predictor.to_device` (a pageable copy),
`Predictor.forward_raw` and `Predictor.count`, and adds the counts up on
the device.

Mix parameters (traffic/<mix>.json): batch, pool (distinct frames), blobs
([min, max] a frame), warmup_batches, thresholds (obj_thresh, iou_thresh,
max_detections: the count's, given to the program and the reference
alike).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yogo_bench import ckpt, manifest, reference, scene, weights
from yogo_bench.trace import span

# the program's API, used as a caller of the port would
from yogo_tpu_torch.infer import Predictor, quantize_stack
from yogo_tpu_torch.models.yogo import YOGO

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bench_weights(cfg: dict, device) -> dict:
    """The configuration's weights as the benchmark holds them: {torch
    name: float32 tensor on `device`}: its checkpoint, or its family's
    initial state from `weights_seed`, with the head set for production
    density where the configuration states one."""
    if cfg.get("checkpoint"):
        _, variables = ckpt.read(cfg["checkpoint"])
        return {k: torch.from_numpy(v).to(device) for k, v in ckpt.torch_weights(variables).items()}
    w = weights.make(manifest.family(cfg["family"]).spec(cfg), cfg["weights_seed"], device)
    return weights.production_density(w, cfg) if "production_density" in cfg else w


def load_weights(stack: torch.nn.Module, w: dict) -> None:
    """The benchmark's weights into the program's module, strictly; a BN's
    `num_batches_tracked`, which no reference reads, starts at 0."""
    extra = {k: torch.zeros((), dtype=torch.long) for k in stack.state_dict()
             if k.endswith("num_batches_tracked") and k not in w}
    stack.load_state_dict({**w, **extra}, strict=True)


def build_predictor(cfg: dict, w: dict, device, quantize: bool = False, calib=(), **thresholds) -> Predictor:
    """The program's Predictor of the configuration: the checkpoint file
    read by the program itself, or the benchmark's seeded weights loaded
    into the program's module; `quantize` builds the program's int8 path,
    calibrated on `calib` (a list of uint8 batches)."""
    dtype = DTYPES[cfg["compute_dtype"]]
    if cfg.get("checkpoint"):
        return Predictor.from_checkpoint(cfg["checkpoint"], half=dtype == torch.bfloat16, device=device,
                                         channels_last=cfg["channels_last"], quantize=quantize, calib=list(calib),
                                         **thresholds)
    model = YOGO.create(tuple(cfg["img_size"]), cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"],
                        model_version=cfg["architecture"], compute_dtype=dtype)
    stack = model.module(device)
    load_weights(stack, w)
    qp = quantize_stack(model, stack, list(calib)) if quantize else None
    return Predictor(model, stack, qp=qp, **thresholds)


def rel_rms(raw: torch.Tensor, ref: torch.Tensor) -> float:
    """|raw - ref| / |ref| (the relative RMS error), in float64."""
    d = raw.double() - ref.double()
    return float(((d * d).sum() / ref.double().pow(2).sum()).sqrt())


class Session:
    def __init__(self, cfg, mix, seed, device, sample, quantize=False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.sample = sample
        self.batch = mix["batch"]
        self.frames, _ = scene.pool(seed, range(mix["pool"]), hw=cfg["img_size"], blobs=mix["blobs"])
        self.order = np.random.default_rng([seed & (2 ** 64 - 1), 1])
        self.w = bench_weights(cfg, self.device)
        self.pred = build_predictor(cfg, self.w, self.device, quantize, calib=[self.frames[:self.batch]],
                                    **mix["thresholds"])
        self.w = {k: v.cpu() for k, v in self.w.items()}  # the reference's, off the card until the check
        self.stream = iter(())
        self.buffers = [np.empty((self.batch, *self.frames.shape[1:]), self.frames.dtype) for _ in range(3)]
        self.n_loaded = 0
        self.prefetcher = ThreadPoolExecutor(max_workers=1)
        self.mask = torch.ones(self.batch, dtype=torch.bool)
        for _ in range(mix["warmup_batches"]):
            self.run_batch(self.load_batch(self.next_indices()), False)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def next_indices(self) -> np.ndarray:
        """The next batch's pool indices: the pool in a fresh seeded order
        each pass."""
        out = []
        while len(out) < self.batch:
            nxt = next(self.stream, None)
            if nxt is None:
                self.stream = iter(self.order.permutation(len(self.frames)))
                continue
            out.append(int(nxt))
        return np.asarray(out)

    def load_batch(self, idx: np.ndarray) -> np.ndarray:
        """The frames `idx` gathered into the next of three reused host
        buffers: the feed stays well ahead of the program (a gather into
        fresh memory costs ~26 ms a batch in page faults, as long as a
        whole base_model batch), and a buffer is refilled only after its
        batch went to the device."""
        buf = self.buffers[self.n_loaded % len(self.buffers)]
        self.n_loaded += 1
        return np.take(self.frames, idx, axis=0, out=buf, mode="wrap")

    def run_batch(self, imgs: np.ndarray, traced: bool):
        with span("h2d", traced):
            x = self.pred.to_device(imgs)
        with span("forward", traced):
            raw = self.pred.forward_raw(x)
        with span("count", traced):
            counts = self.pred.count(raw, self.mask)
        return raw, counts

    def window(self, seconds: float, traced: bool, clock) -> dict:
        """Batches back to back for `seconds`; the rate is every image
        counted over the time until the last batch's counts are on the
        host. Keeps every batch's counts, and the heads of
        `sample` batches drawn from the seed (reservoir sampling)."""
        sample = self.sample
        pick = np.random.default_rng([self.seed & (2 ** 64 - 1), 2])
        kept = []
        total = torch.zeros(self.cfg["num_classes"], dtype=torch.int64, device=self.device)
        idx = self.next_indices()
        pending = self.prefetcher.submit(self.load_batch, idx)
        n = 0
        with span("window", traced):
            t0 = clock()
            while clock() - t0 < seconds:
                with span("feed", traced):
                    imgs, this = pending.result(), idx
                    idx = self.next_indices()
                    pending = self.prefetcher.submit(self.load_batch, idx)
                raw, counts = self.run_batch(imgs, traced)
                total += counts
                if len(kept) < sample:
                    kept.append((this, raw.clone(), counts))
                else:
                    j = int(pick.integers(0, n + 1))
                    if j < sample:
                        kept[j] = (this, raw.clone(), counts)
                n += 1
            total = total.cpu()
            elapsed = clock() - t0
        pending.result()
        self.kept = [(this, raw, counts.cpu().numpy()) for this, raw, counts in kept]
        return {
            "attempted": n * self.batch,
            "failed": 0,
            "elapsed_s": elapsed,
            "metrics": {"count_images_per_s": n * self.batch / elapsed},
            "counters": {"batches": n, "images": n * self.batch, "batch": self.batch,
                         "counted": [int(c) for c in total]},
        }

    def release(self) -> None:
        self.prefetcher.shutdown(wait=True)
        del self.pred
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """For each kept batch: the program's head against the reference's
        float32 head of the same frames (the relative RMS error
        |prog - ref| / |ref|, the worst batch), and the program's
        counts against the reference's decode, NMS and count of the
        program's own head (exact)."""
        w = {k: v.to(self.device) for k, v in self.w.items()}
        rel, gap = 0.0, 0
        for this, raw, counts in self.kept:
            ref = reference.head(w, self.frames[this], self.cfg)
            rel = max(rel, rel_rms(raw, ref))
            ref_counts = reference.counts(raw, self.cfg, **self.mix["thresholds"])
            gap = max(gap, int(np.abs(ref_counts - counts).sum()))
        return {"head_rel_rms": rel, "count_gap": gap}


def setup(cfg, mix, seed, device, opts, quantize=False, seconds=None) -> Session:
    """opts: the cell's limits file (`sample`: heads kept for the check)."""
    return Session(cfg, mix, seed, device, opts["sample"], quantize)
