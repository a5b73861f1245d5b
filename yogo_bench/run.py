"""Run one cell of BENCHMARK.json once and print its result:

    python3 -m yogo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights, frames, the program, its
warm-up) counts as setup_s, from the start of the process; then the
cell's driver runs the measured window; with --trace 1 under
torch.profiler, whose trace the per-layer readers (metrics/) read. After
the window the device's peak memory is read, the program is freed and the
window's outputs are held against the plain reference (reference.py):
each number compared, with its limit from limits/<cell>.json, goes to the
last lines of standard error and, under "checks", to the last key of the
result. The last line of standard output is the result:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

with the card's power limit beside its peak memory in "device" (a card set
below its 700 W runs slower under load).

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and if jax, jaxlib, flax or yogo_tpu (the JAX
package) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yogo_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), at T0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK") - (time.perf_counter() - T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(man: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: float = T0, clock=time.perf_counter, resize: dict = None) -> dict:
    """One run of `workload` on `device`; the result's dict. `resize`
    ({"config": {...}, "traffic": {...}} of keys to replace) shrinks a cell
    for the CPU tests."""
    import torch

    from yogo_bench import manifest
    from yogo_bench.trace import Tracer

    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    opts = manifest.limits(workload)
    if resize:
        cfg.update(resize.get("config", {}))
        mix.update(resize.get("traffic", {}))
    drv = manifest.driver(mix)
    on_card = torch.device(device).type == "cuda"

    sess = drv.setup(cfg, mix, seed, device, opts, seconds=seconds)
    setup_s = clock() - start
    tracer = Tracer() if trace else None
    try:
        with tracer or contextlib.nullcontext():
            out = sess.window(seconds, trace, clock)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        rec = tracer.record() if trace else None
    finally:
        sess.release()
    del tracer
    values = sess.check()
    checks = {name: [values[name], limit] for name, limit in opts["checks"].items()}

    ctx = {"trace": rec, "out": out, "counters": out["counters"], "cfg": cfg,
           "card": torch.cuda.get_device_name(0) if on_card else "cpu"}
    metrics = {}
    if not trace:
        for m in manifest.end_to_end(man, workload):
            v = setup_s if m["name"] == "setup_s" else out["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in manifest.per_layer(man, workload):
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ctx["card"],
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if on_card:
        from yogo_bench import peaks

        dev["power_limit_w"] = peaks.power_limit_w()
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["window_s"]
        result["breakdown"] = rec["breakdown"]
    for line in out.get("notes", []):
        print(line, file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m yogo_bench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = T0 - process_age()

    import torch

    from yogo_bench import manifest

    man = manifest.load()
    chips = manifest.cell(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"yogo_bench: the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", start)
    found = forbidden_modules()
    if found:
        print(f"yogo_bench: modules of the JAX stack were loaded: {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
