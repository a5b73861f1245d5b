"""On the card (marker `cuda`; each skips without one): every cell runs
through the command and reads correct. Run with
`python -m pytest -m cuda yogo_bench/tests` on the GPU machine."""

import json
import subprocess
import sys

import pytest
import torch

from yogo_bench import manifest

MAN = manifest.load()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cuda_every_cell_runs_and_is_correct(workload, trace):
    _need_card()
    out = subprocess.run([sys.executable, "-m", "yogo_bench.run", "--workload", workload, "--seed", "20261017",
                          "--seconds", "2", "--trace", str(trace)], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    wanted = manifest.per_layer(MAN, workload) if trace else manifest.end_to_end(MAN, workload)
    assert {m["name"] for m in wanted} >= set(r["metrics"]) and r["metrics"]
