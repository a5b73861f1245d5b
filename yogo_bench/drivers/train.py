"""The train driver: the program's training step (yogo_tpu_torch.train.
make_train_step with make_optimizer's clamped AdamW and cosine schedule)
on B golden-scene frames and their label grids a step, handed from host
memory to the device through data/prefetch.py's prefetch_to_device as
Trainer does, with a CPU generator seeded for each step (the flips and the
channel-dropout masks are the step's draws from it).

Set-up builds one training state from the seed's initial weights and
drives it through its first `first_steps` steps, through the window's own
call and feed, on batches that share no frame; the window then carries on
with the same state. The check replays those first steps in the plain
reference from the same weights, batches and step seeds, and three steps
from inside the window: the window's step k (k drawn from the seed below
check_within) takes a copy of the parameters and of AdamW's moments
before it, and the reference follows steps k, k+1 and k+2 from that
state (the program's own: the stage between set-up and step k is not
followed).

Mix parameters: batch, pool, blobs, first_steps, check_within, and the job's
learning_rate, weight_decay, decay_factor, total_steps, clip_value and
loss weights (iou_weight, no_obj_weight, classify_weight,
label_smoothing).
"""

from __future__ import annotations

import numpy as np
import torch

from yogo_bench import manifest, reference, scene, weights
from yogo_bench.drivers.count import DTYPES, load_weights
from yogo_bench.trace import span

from yogo_tpu_torch.data.prefetch import prefetch_to_device
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step

BETA1 = 0.9


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step `step` of a run seeded `seed` (step 2**32:
    the initial weights)."""
    return int(np.random.SeedSequence((int(seed) & (2 ** 64 - 1), 7, int(step))).generate_state(1, np.uint64)[0] >> 1)


def moments(opt, named) -> tuple:
    """Copies of AdamW's ({name: first moment}, {name: second moment}) of
    the parameters `named` ((name, parameter) pairs); zeros where the
    optimizer holds no state."""
    out = ({}, {})
    for k, p in named:
        st = opt.state.get(p, {})
        for d, key in zip(out, ("exp_avg", "exp_avg_sq")):
            d[k] = st[key].detach().clone() if key in st else torch.zeros_like(p)
    return out


def norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def worst_gap(prog: dict, ref: dict, leaves) -> float:
    """max over `leaves` of |prog norm - ref norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


class Session:
    def __init__(self, cfg, mix, seed, device, opts):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.batch = mix["batch"]
        model = YOGO.create(tuple(cfg["img_size"]), cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"],
                            model_version=cfg["architecture"], compute_dtype=DTYPES[cfg["compute_dtype"]])
        w = weights.make(manifest.family(cfg["family"]).spec(cfg), step_seed(seed, 2 ** 32), self.device)
        stack = model.module(self.device, channels_last=cfg["channels_last"])
        load_weights(stack, w)
        self.w0 = {k: v.cpu() for k, v in w.items()}
        del w
        opt, sched, _ = make_optimizer(stack.parameters(), mix["learning_rate"], mix["weight_decay"],
                                       mix["decay_factor"], mix["total_steps"], mix["clip_value"])
        loss_kwargs = {k: mix[k] for k in ("no_obj_weight", "iou_weight", "classify_weight", "label_smoothing")}
        self.step = make_train_step(model, loss_kwargs, augment=True)
        self.state = TrainState(stack=stack, optimizer=opt, scheduler=sched)
        self.frames, labels = scene.pool(seed, range(mix["pool"]), hw=cfg["img_size"], blobs=mix["blobs"])
        sx, sy = reference.grid(cfg)
        self.grids = np.stack([scene.label_grid(lb, sx, sy) for lb in labels])
        self.order = np.random.default_rng([seed & (2 ** 64 - 1), 4])
        self.used = []  # each step's pool indices
        self.feed = prefetch_to_device(self._batches(), self.device)
        self.gen = torch.Generator()
        self.n_steps = 0
        self.k = int(np.random.default_rng([seed & (2 ** 64 - 1), 5]).integers(0, mix["check_within"]))

        names = [k for k, _ in stack.named_parameters()]
        self.theta0 = {k: p.detach().clone() for k, p in stack.named_parameters()}
        self.losses = []
        for t in range(mix["first_steps"]):
            loss = self.one_step(False)
            self.losses.append(float(loss))
            if t == 0:
                # Adam's first moment after one step is (1 - beta1) x the
                # gradient it took; a step that kept no state took none
                self.grad1 = {k: opt.state[p]["exp_avg"].detach().clone() / (1 - BETA1)
                              if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                              for k, p in zip(names, stack.parameters())}
        self.theta_n = {k: p.detach().clone() for k, p in stack.named_parameters()}
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _batches(self):
        """Host batches (frames, label grids, mask) of fresh pool orders; a
        pass through the pool shares no frame between its batches."""
        ones = np.ones(self.batch, np.float32)
        # three reused host buffers: the prefetcher copies a batch into its
        # pinned slot before it asks for the next, and a gather into fresh
        # memory would cost its page faults on every batch
        bufs = [(np.empty((self.batch, *self.frames.shape[1:]), self.frames.dtype),
                 np.empty((self.batch, *self.grids.shape[1:]), self.grids.dtype)) for _ in range(3)]
        n = 0
        while True:
            perm = self.order.permutation(len(self.frames))
            for i in range(0, len(perm) - self.batch + 1, self.batch):
                idx = perm[i:i + self.batch]
                self.used.append(idx)
                f, g = bufs[n % 3]
                n += 1
                yield (np.take(self.frames, idx, axis=0, out=f, mode="wrap"),
                       np.take(self.grids, idx, axis=0, out=g, mode="wrap"), ones)

    def one_step(self, traced: bool):
        with span("feed", traced):
            imgs, labels, mask = next(self.feed)
        self.gen.manual_seed(step_seed(self.seed, self.n_steps))
        with span("step", traced):
            self.state, loss, _ = self.step(self.state, imgs, labels, mask, self.gen)
        self.n_steps += 1
        return loss

    def window(self, seconds: float, traced: bool, clock) -> dict:
        """Steps back to back for `seconds` (and at least to step k + 3);
        the rate is every image stepped over the time until the last step's
        loss is on the host. Steps k to k + 2 keep their losses, the state
        before step k and the first moments after it, and the parameters
        after step k + 2, as copies on the device."""
        n, k = 0, self.k
        win = {"losses": []}
        with span("window", traced):
            t0 = clock()
            while clock() - t0 < seconds or n < k + 3:
                if n == k:
                    named = list(self.state.stack.named_parameters())
                    win.update(start=self.n_steps, theta={name: p.detach().clone() for name, p in named},
                               moments=moments(self.state.optimizer, named))
                loss = self.one_step(traced)
                if k <= n < k + 3:
                    win["losses"].append(loss.detach().clone())
                    named = list(self.state.stack.named_parameters())
                    if n == k:
                        win["m_after"] = moments(self.state.optimizer, named)[0]
                    if n == k + 2:
                        win["after"] = {name: p.detach().clone() for name, p in named}
                n += 1
            last = float(loss)
            elapsed = clock() - t0
        win["losses"] = [float(x) for x in win["losses"]]
        self.win = win
        return {
            "attempted": n * self.batch,
            "failed": 0 if np.isfinite(last) else n * self.batch,
            "elapsed_s": elapsed,
            "metrics": {"train_images_per_s": n * self.batch / elapsed},
            "counters": {"steps": n, "images": n * self.batch, "batch": self.batch, "last_loss": last},
        }

    def release(self) -> None:
        self.feed.close()
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, cast=reference.f32, half_batch=False):
        """The plain reference's first steps from the same weights, batches
        and step seeds: (losses, first clamped gradient, parameters after
        the last)."""
        ref_w = {k: v.to(self.device) for k, v in self.w0.items()}
        batches = [(self.frames[self.used[t]], self.grids[self.used[t]], step_seed(self.seed, t))
                   for t in range(len(self.losses))]
        losses, grad1, after = reference.train_steps(ref_w, batches, self.cfg, self.mix, cast=cast,
                                                     half_batch=half_batch)
        return losses, grad1, after[-1]

    def window_steps(self) -> tuple:
        """The program's window steps k to k + 2: (losses, the clamped
        gradient of step k, worked out from AdamW's first moment before and
        after it, parameters after k + 2)."""
        w = self.win
        m0 = w["moments"][0]
        grad = {name: (w["m_after"][name] - BETA1 * m0[name]) / (1 - BETA1) for name in m0}
        return w["losses"], grad, w["after"]

    def reference_window(self, cast=reference.f32, half_batch=False):
        """The plain reference's steps k to k + 2 from the program's state
        before step k (its parameters and AdamW's moments), on the same
        batches and step seeds."""
        w = self.win
        start_w = {**{k: v.to(self.device) for k, v in self.w0.items() if k not in w["theta"]}, **w["theta"]}
        batches = [(self.frames[self.used[t]], self.grids[self.used[t]], step_seed(self.seed, t))
                   for t in range(w["start"], w["start"] + 3)]
        losses, grad, after = reference.train_steps(start_w, batches, self.cfg, self.mix, cast=cast,
                                                    half_batch=half_batch, start=w["start"], moments=w["moments"])
        return losses, grad, after[-1]

    def check(self) -> dict:
        first = compare((self.losses, self.grad1, self.theta_n), self.reference_steps(), self.theta0)
        win = compare(self.window_steps(), self.reference_window(), self.win["theta"])
        return {**first, **{f"win_{k}": v for k, v in win.items()}}


def compare(prog, ref, theta0) -> dict:
    """Each step's loss (relative gap, the worst step), the first clamped
    gradient's norm and the change of the parameters' norm over the first
    steps, each by the worst leaf, of `prog` against `ref`, both (losses,
    first gradient, parameters after the last step). The change leaves out
    leaves whose reference gradient is under a thousandth of the median
    leaf's (a conv bias in front of a BN)."""
    (lp, gp, tp), (lr, gr, tr) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    gp, gr = norms(gp), norms(gr)
    med = float(np.median(list(gr.values())))
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    dp = norms({k: tp[k] - theta0[k].to(tp[k].device) for k in moved})
    dr = norms({k: tr[k] - theta0[k].to(tr[k].device) for k in moved})
    return {"loss_gap": loss_gap, "grad_gap": worst_gap(gp, gr, list(gr)), "change_gap": worst_gap(dp, dr, moved)}


def setup(cfg, mix, seed, device, opts, seconds=None) -> Session:
    return Session(cfg, mix, seed, device, opts)
