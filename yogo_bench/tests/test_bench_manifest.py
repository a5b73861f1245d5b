"""BENCHMARK.json keeps the contract, and every piece is found by name:
a later change adds a configuration, mix, cell or metric as files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from yogo_bench import flops, manifest

MAN = manifest.load()


def test_manifest_keeps_the_contract():
    assert manifest.validate(MAN) == []


@pytest.mark.parametrize("bad", [
    {"name": "has space"}, {"name": "a,b"}, {"name": "a/b"}, {"name": "x" * 65}, {"name": ".dot"},
])
def test_bad_names_are_refused(bad):
    man = json.loads(json.dumps(MAN))
    man["per_layer"][0].update(bad)
    assert manifest.validate(man)


@pytest.mark.parametrize("unit", ["tokens per second", "x" * 17, "µs", ""])
def test_bad_units_are_refused(unit):
    man = json.loads(json.dumps(MAN))
    man["end_to_end"][0]["unit"] = unit
    assert any("unit" in p for p in manifest.validate(man))


@pytest.mark.parametrize("key,value", [("bound", 0.3), ("bound", 0.001), ("source", "program_span")])
def test_end_to_end_bounds_and_sources(key, value):
    man = json.loads(json.dumps(MAN))
    man["end_to_end"][0][key] = value
    assert manifest.validate(man)


def test_a_configuration_of_an_unknown_family_is_refused(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs/odd.json").write_text(json.dumps({**manifest.config(MAN, "base_model"), "family": "odd"}))
    man = json.loads(json.dumps(MAN))
    man["configs"][0]["file"] = str(tmp_path / "configs/odd.json")
    problems = manifest.validate(man)
    assert any("family 'odd'" in p for p in problems), problems
    assert manifest.validate(MAN) == []


def test_an_extra_key_is_refused():
    man = json.loads(json.dumps(MAN))
    man["per_layer"][0]["why"] = "no"
    assert manifest.validate(man)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, w["config"])
    mix = manifest.traffic(w["traffic"])
    opts = manifest.limits(cell)
    assert cfg["name"] == w["config"]
    assert manifest.driver(mix).setup
    assert opts["checks"]
    for m in manifest.per_layer(MAN, cell):
        assert callable(manifest.reader(m["name"]).read)
    names = {m["name"] for m in manifest.end_to_end(MAN, cell)}
    assert "setup_s" in names and len(names) >= 2


def test_counters_reproduce_the_published_totals():
    base = manifest.config(MAN, "base_model")
    cnx = manifest.config(MAN, "convnext_small")
    assert round(flops.macs_per_image(base) / 1e9) == 11
    assert round(flops.macs_per_image(cnx) / 1e9) == 136
    assert round(flops.stem_bytes(base, 64) / 1e6, 1) == 458.9


def test_a_later_change_adds_pieces_as_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    per-layer metric by new files and entries alone, and a configuration
    of a new family (families/toy_stack.py, which delegates to the conv
    stack) whose cell runs correct at a small size; no file there is
    edited, and the harness finds each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "yogo_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "yogo_bench").rglob("*") if p.is_file()}
    man = json.loads(json.dumps(MAN))
    (root / "yogo_bench/configs/dummy.json").write_text(json.dumps(
        {**manifest.config(MAN, "base_model"), "name": "dummy",
         "checkpoint": "tests/goldens/trained_base_model_fullres.ckpt"}))
    (root / "yogo_bench/traffic/count_b8.json").write_text(json.dumps({**manifest.traffic("count"), "batch": 8}))
    (root / "yogo_bench/limits/dummy.count_b8.json").write_text(json.dumps(manifest.limits("base_model.count")))
    (root / "yogo_bench/metrics/launches.count.py").write_text(
        "def read(ctx):\n    return float(sum(n for n, _ in ctx['trace']['kernels'].values()))\n")
    (root / "yogo_bench/families/toy_stack.py").write_text(
        '"""A family that is the conv stack under another name."""\n'
        "from yogo_bench.families.conv_stack import forward, grid, macs_per_image, spec  # noqa: F401\n")
    toy = {k: v for k, v in manifest.config(MAN, "base_model").items() if not k.startswith("checkpoint")}
    (root / "yogo_bench/configs/toy.json").write_text(json.dumps(
        {**toy, "name": "toy", "family": "toy_stack", "architecture": "base_model", "weights_seed": 0}))
    (root / "yogo_bench/limits/toy.count.json").write_text(json.dumps(manifest.limits("base_model.count")))
    man["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                           "file": "yogo_bench/configs/dummy.json", "reduced": [], "why": "a test"})
    man["configs"].append({"name": "toy", "source": "https://example.org/toy",
                           "file": "yogo_bench/configs/toy.json", "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy.count_b8", "config": "dummy", "traffic": "count_b8", "chips": 1,
                             "why": "a test"})
    man["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "count", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "launches.count", "unit": "launches", "better": "lower",
                             "source": "device_trace", "layer": "device", "moves": "count_images_per_s",
                             "workloads": ["dummy.count_b8", "toy.count"]})
    for m in man["end_to_end"]:
        if m["name"] == "count_images_per_s":
            m["workloads"] += ["dummy.count_b8", "toy.count"]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.validate(man, root) == []
    code = (
        "import json, sys; from yogo_bench import manifest as m; man = m.load();"
        "w = m.cell(man, 'dummy.count_b8'); c = m.config(man, w['config']); t = m.traffic(w['traffic']);"
        "l = m.limits('dummy.count_b8');"
        "r = m.reader('launches.count').read({'trace': {'kernels': {'k': [3, 1.0]}}});"
        "print(json.dumps([c['name'], t['batch'], sorted(l['checks']), r, m.driver(t).__name__]))"
    )
    env = {**os.environ, "PYTHONPATH": str(manifest.ROOT)}  # the program; yogo_bench is the copy's
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, check=True)
    assert json.loads(out.stdout) == ["dummy", 8, ["count_gap", "head_rel_rms"], 3.0, "yogo_bench.drivers.count"]
    assert str(root) in subprocess.run([sys.executable, "-c", "import yogo_bench; print(yogo_bench.__file__)"],
                                       cwd=root, env=env, capture_output=True, text=True).stdout
    code = (
        "import json, time; from yogo_bench import flops, manifest as m, reference, run; man = m.load();"
        "c = m.config(man, 'toy');"
        "rs = {'config': {'img_size': [96, 128], 'compute_dtype': 'float32'},"
        "      'traffic': {'batch': 2, 'pool': 4, 'blobs': [2, 5], 'warmup_batches': 1}};"
        "r = run.run_cell(man, 'toy.count', 98765432101, 0.5, False, 'cpu', start=time.perf_counter(), resize=rs);"
        "print(json.dumps([m.family(c['family']).__file__, flops.macs_per_image(c), reference.grid(c),"
        "                  r['correct'], r['attempted'], r['checks']]))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    path, macs, grid, correct, attempted, checks = json.loads(out.stdout.splitlines()[-1])
    assert path == str(root / "yogo_bench/families/toy_stack.py")
    assert (macs, grid) == (flops.macs_per_image(manifest.config(MAN, "base_model")), [129, 97])
    assert correct and attempted > 0, checks
    after = {p: p.read_bytes() for p in before}
    assert after == before
