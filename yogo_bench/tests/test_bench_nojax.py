"""Nothing the benchmark runs loads the JAX stack, and the plain
reference loads nothing of the program; names are compared whole, by
their top-level part (yogo_tpu_torch begins with yogo_tpu)."""

import json
import subprocess
import sys

from yogo_bench import manifest, run


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("yogo_tpu_torch", "yogo_tpu_torch.infer", "jaxtyping", "flaxen", "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "yogo_tpu", "yogo_tpu.ops", "flax", "jaxlib.xla_client"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["flax", "jax.numpy", "jaxlib.xla_client", "yogo_tpu", "yogo_tpu.ops"]


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "; import sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_its_drivers_load_no_jax():
    mods = _loaded("import yogo_bench.run, yogo_bench.controls, yogo_bench.drivers.count, "
                   "yogo_bench.drivers.train, yogo_bench.loadgen")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "yogo_tpu"}
    assert "yogo_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import yogo_bench.reference, yogo_bench.ckpt, yogo_bench.weights, yogo_bench.scene, "
                   "yogo_bench.flops, yogo_bench.peaks")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "yogo_tpu", "yogo_tpu_torch"}


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "-m", "yogo_bench.run", "--workload", "base_model.count",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
