"""Time the int8 conv kernel at the main path's six timed sites on one NVIDIA GPU.

    python3 -m yogo_tpu_torch.tools.int8_conv_sites [--label NAME] [--out FILE]

The sites are those of `chip_smoke.py` phases 9 and 10 at B=64, 772x1032:
base_model's int8 blocks 4 (3x3 s2, int8 out), 5 (3x3 s1, int8 out) and 6
(3x3 s1, f32 out), and ConvNeXt-Small's stage2 pwconv1 (1x1, 384 -> 1,536),
pwconv2 (1,536 -> 384) and down2_conv (2x2 s2, 192 -> 384), f32 out, on
seeded random codes and weights. Each kernel output is held bit-equal to
`int8_conv_reference`, then timed with CUDA events (median of 10 reps of 20
back-to-back launches), beside its bound (the larger of its bytes over the
card's memory rate and its int8 operations over its int8 rate) and, at the
1x1 sites, `torch._int_mm` of the same product alone (s32 out, no epilogue).
It uses only the wrapper's public calls, so a copy of this file and of
tools/timing.py in an unpacked earlier checkout times that checkout's
kernel (run from its root) in the same machine call as this one.
Prints one JSON line per site and, with `--out`, appends them to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops import int8_conv as ic
from yogo_tpu_torch.tools.timing import INT8_RATE, MEM_RATE, card, cuda_ms, rate

# name -> (codes (B, H, W, C_in), C_out, kernel, stride, act, int8 out)
SITES = {
    "block4": ((64, 193, 258, 128), 128, 3, 2, "leaky_relu", True),
    "block5": ((64, 97, 129, 128), 128, 3, 1, "leaky_relu", True),
    "block6": ((64, 97, 129, 128), 128, 3, 1, "leaky_relu", False),
    "pwconv1": ((64, 48, 64, 384), 1536, 1, 1, None, False),
    "pwconv2": ((64, 48, 64, 1536), 384, 1, 1, None, False),
    "down2_conv": ((64, 96, 129, 192), 384, 2, 2, None, False),
}


def site_args(name: str, batch: int, seed: int = 0):
    """(args, kwargs) of the int8_conv call at site `name` with `batch` images."""
    (_, h, w, cin), cout, k, s, act, s8 = SITES[name]
    rng = np.random.default_rng(seed)
    cp = ic.padded_channels(cin)
    x = np.zeros((batch, h, w, cp), np.int8)
    x[..., :cin] = rng.integers(-127, 128, (batch, h, w, cin), dtype=np.int8)
    w8 = ic.pack_weights(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8))
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
    dev = torch.device("cuda")
    args = (torch.from_numpy(x).to(dev), w8.to(dev), deq.to(dev), bias.to(dev))
    kw = dict(cin=cin, stride=s, padding=(k - 1) // 2, act=act,
              out_scale=torch.tensor([0.05], device=dev) if s8 else None)
    return args, kw


def measure(name: str, batch: int, reps: int) -> dict:
    args, kw = site_args(name, batch)
    q, w8 = args[:2]
    cout, k, _, cp = w8.shape
    out = ic.int8_conv(*args, **kw)
    want = ic.int8_conv_reference(*args, **kw)
    torch.cuda.synchronize()
    if out.shape != want.shape or not torch.equal(out, want):
        raise AssertionError(f"{name}: the kernel differs from its plain version")
    del want
    kind = torch.cuda.get_device_name(0)
    m = out.shape[0] * out.shape[1] * out.shape[2]
    n_ops = 2 * m * cout * k * k * kw["cin"]
    n_bytes = q.numel() + w8.numel() + 8 * cout + out.numel() * out.element_size()
    bound = {"bytes": n_bytes / rate(MEM_RATE, kind) * 1e3, "operations": n_ops / rate(INT8_RATE, kind) * 1e3}
    rec = {"site": name, "in": list(q.shape), "out": list(out.shape), "out_dtype": str(out.dtype).split(".")[-1],
           "ms": cuda_ms(lambda: ic.int8_conv(*args, **kw), reps),
           "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
           "bytes": n_bytes, "operations": n_ops}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if k == 1:  # the s32 product alone, cuBLASLt's
        a = q.reshape(-1, cp)
        w_kn = w8.reshape(cout, cp).t()
        rec["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a, w_kn), reps)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sites", nargs="*", default=list(SITES))
    ap.add_argument("--out", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_sites: CUDA is not available", file=sys.stderr)
        return 1
    kernels.build_all(["int8_conv"])
    smi = card()
    recs = []
    for name in a.sites:
        rec = {"label": a.label, "card": smi, **measure(name, a.batch, a.reps)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        torch.cuda.empty_cache()
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        with a.out.open("a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
