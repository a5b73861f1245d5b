"""Where a served request's time goes, on a GPU machine.

    python3 -m yogo_tpu_torch.tools.serve_profile [--batches 8 64] [--threads 64]
        [--frames-per-request 1 8] [--switch-intervals 0.005] [--seconds 8]

Serves tests/goldens/trained_base_model_fullres.ckpt in bf16 (772x1032) and,
for each micro-batch size:
  1. the serving path without HTTP: fwd_dispatch + fwd_fetch of full
     batches back to back from one thread (the batcher's own ceiling), and
     the host time of the per-frame formatter on the golden frames;
  2. for each interpreter switch interval (sys.setswitchinterval: how long
     a thread that wants the interpreter lock waits before the holder is
     asked to drop it) and each request size (raw single frames, or batch
     requests of several), ~`--seconds` of load from client processes
     (tools/serve_load.measure) over one window: requests/s, latency p50 /
     p99, batch occupancy, and the server's /metrics timers: queue wait,
     the collector's enqueue time per batch, dispatch-to-fetched time,
     formatter time per frame and server-side time per request.
Prints one JSON line per measurement and writes them all to
chiprun_out/serve_profile.json. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CKPT = REPO / "tests" / "goldens" / "trained_base_model_fullres.ckpt"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="serve: where a request's time goes")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    p.add_argument("--threads", type=int, default=64)
    p.add_argument("--switch-intervals", type=float, nargs="+", default=[0.005])
    p.add_argument("--frames-per-request", type=int, nargs="+", default=[1, 8])
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)

    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.ops.postprocess import scatter_candidates
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.tools import serve_load
    from yogo_tpu_torch.tools.golden_scene import gen_golden_images
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint

    dev = resolve_device(a.device)
    smi = "not a GPU"
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    frames = list(gen_golden_images()[0])
    records = []

    def emit(rec):
        rec["device"] = smi
        records.append(rec)
        print(json.dumps(rec), flush=True)

    default_interval = sys.getswitchinterval()
    for bsz in a.batches:
        srv = build_server(CKPT, port=0, batch_size=bsz, half=True, device=dev, linger_ms=5.0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            # 1. the serving path without HTTP, and the formatter alone
            dispatch, fetch = srv.yogo_batcher._fwd_dispatch, srv.yogo_batcher._fwd_fetch
            batch = [frames[i % len(frames)] for i in range(bsz)]
            for _ in range(3):
                fetch(dispatch(batch))
            t0, reps = time.perf_counter(), 20
            for _ in range(reps):
                rows, idx, _ = fetch(dispatch(batch))
            serial_ms = (time.perf_counter() - t0) / reps * 1e3
            pending, enqueue, t0 = [], [], time.perf_counter()
            for _ in range(reps):  # two in flight, as pipeline_depth=2 allows
                t1 = time.perf_counter()
                pending.append(dispatch(batch))
                enqueue.append((time.perf_counter() - t1) * 1e3)
                if len(pending) == 2:
                    rows, idx, _ = fetch(pending.pop(0))
            for h in pending:
                fetch(h)
            pipelined_ms = (time.perf_counter() - t0) / reps * 1e3
            sx, sy = load_checkpoint(CKPT)[0].grid
            t0 = time.perf_counter()
            for i in range(min(len(frames), bsz)):
                grid = scatter_candidates(rows[i], idx[i], rows.shape[-1], sy, sx)
                body = json.dumps(format_detections(grid, srv.yogo_info["classes"], obj_thresh=0.5,
                                                    iou_thresh=0.5, min_class_confidence_threshold=0.0))
            format_ms = (time.perf_counter() - t0) / min(len(frames), bsz) * 1e3
            emit({"batch": bsz, "what": "no_http", "dispatch_fetch_serial_ms": serial_ms,
                  "dispatch_fetch_two_in_flight_ms": pipelined_ms,
                  "enqueue_ms_median_two_in_flight": sorted(enqueue)[len(enqueue) // 2],
                  "images_per_s_two_in_flight": bsz / pipelined_ms * 1e3,
                  "format_and_json_ms_per_frame": format_ms, "response_bytes": len(body)})

            # 2. under load, per switch interval and request size
            for interval, fpr in ((i, f) for i in a.switch_intervals for f in a.frames_per_request):
                sys.setswitchinterval(interval)
                try:
                    rec = serve_load.measure(srv.server_address[1], frames, None, threads=a.threads,
                                             seconds=a.seconds, frames_per_request=fpr)
                finally:
                    sys.setswitchinterval(default_interval)
                emit({"batch": bsz, "what": "load", "switch_interval_s": interval,
                      **rec, "errors": len(rec["errors"])})
        finally:
            srv.shutdown()
            srv.yogo_batcher.shutdown()
            srv.server_close()
            th.join(timeout=30)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_profile.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
