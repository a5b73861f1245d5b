"""The port's parallel/ package (yogo_tpu_torch/parallel/) against the JAX
package's: the pad and row helpers on seeded numpy, the process-group
set-up, and global BatchNorm at world 2 (two gloo ranks on the CPU,
tests/torch_parallel_worker.py) against one process of the port on the
concatenated batch and against flax's BatchNorm jitted over a 2-device mesh.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.torch_parallel_worker import load_rank, run_workers
from yogo_tpu.parallel import mesh as jmesh
from yogo_tpu_torch.models.yogo import _batch_norm
from yogo_tpu_torch.parallel import distributed, mesh

RTOL = ATOL = 1e-5


# ------------------------------------------------------------- pad and rows
def _batch(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, 1, 4, 4)).astype(np.uint8),
            rng.random((n, 6, 2, 2)).astype(np.float32), np.array([1, 1, 0][:n], np.float32))


@pytest.mark.parametrize("fn, arg", [("pad_batch_to_size", 5), ("pad_batch_to_size", 3),
                                     ("pad_batch_to_multiple", 4), ("pad_batch_to_multiple", 3)])
def test_pad_helpers_equal_jax_s(fn, arg):
    got = getattr(mesh, fn)(*_batch(), arg)
    want = getattr(jmesh, fn)(*_batch(), arg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # pad rows are copies of row 0, masked out: they enter BatchNorm as in JAX
    if got[0].shape[0] > 3:
        np.testing.assert_array_equal(got[0][3:], np.repeat(got[0][:1], got[0].shape[0] - 3, 0))
        assert not got[2][3:].any()


def test_one_process_helpers_equal_jax_s():
    arr = np.arange(24.0).reshape(8, 3)
    np.testing.assert_array_equal(mesh.local_rows(arr, 4), jmesh.local_rows(arr, 4))
    assert mesh.n_data() == 1 and distributed.process_shard() == (0, 1)
    t = torch.arange(6.0)
    assert mesh.gather_rows(t) is t and distributed.all_reduce_sum(t) is t
    with pytest.raises(ValueError, match="divisible"):
        mesh.validate_spatial_height(3, 772)
    mesh.validate_spatial_height(4, 772)


def test_fsdp_rule_equals_jax_s_on_the_output_axis():
    """fsdp_sharding_tree shards a leaf's last (output) axis when it holds
    >= 4096 elements and divides; the port's rule reads torch's dim 0."""
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("data",))
    for shape_hwio in [(3, 3, 64, 128), (3, 3, 16, 16), (1, 1, 128, 7), (128,), (3, 3, 128, 255)]:
        leaf = np.zeros(shape_hwio, np.float32)
        jax_sharded = jmesh.fsdp_sharding_tree(mesh2, leaf).spec != P()
        if len(shape_hwio) == 4:
            h, w, i, o = shape_hwio
            leaf_t = torch.zeros(o, i, h, w)
        else:
            leaf_t = torch.zeros(shape_hwio)
        assert mesh.fsdp_sharded(leaf_t, 2) == jax_sharded, shape_hwio


# ------------------------------------------------------------ process group
def test_initialize_multihost_without_a_world_creates_no_group(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize_multihost() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("names", ["torchrun", "jax"])
def test_initialize_multihost_reads_torchrun_s_and_jax_s_names(monkeypatch, names):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    if names == "torchrun":
        env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "3"}
    else:
        env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
               "JAX_PROCESS_ID": "3"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    assert distributed.initialize_multihost(device="cpu", timeout_s=7.0) is True
    assert seen["backend"] == "gloo" and seen["init_method"] == "tcp://10.0.0.1:1234"
    assert (seen["world_size"], seen["rank"]) == (4, 3)
    assert seen["timeout"].total_seconds() == 7.0 and seen["device_id"] is None
    seen.clear()
    assert distributed.initialize_multihost(backend="gloo", device="cpu") is True
    assert seen["backend"] == "gloo"


def test_initialize_multihost_needs_an_address_and_a_rank(monkeypatch):
    for name in ("RANK", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize_multihost(device="cpu")


def test_a_rank_never_drops_to_the_cpu_on_its_own():
    assert distributed.local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.local_device(None)


# ------------------------------------------------------ global BatchNorm
@pytest.fixture(scope="module")
def bn_run(tmp_path_factory):
    """Two gloo ranks normalise their halves of an 8-row batch; the last
    row is a copy of rank 1's first (a pad row, which enters the
    statistics as in JAX)."""
    d = tmp_path_factory.mktemp("bn")
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (8, 6, 5, 7)).astype(np.float32)
    x[7] = x[4]
    inputs = dict(x=x, gy=rng.normal(size=x.shape).astype(np.float32),
                  weight=rng.normal(1.0, 0.3, 6).astype(np.float32),
                  bias=rng.normal(0.0, 0.3, 6).astype(np.float32),
                  running_mean=rng.normal(0.0, 0.1, 6).astype(np.float32),
                  running_var=rng.uniform(0.5, 2.0, 6).astype(np.float32))
    np.savez(d / "bn.npz", **inputs)
    run_workers("bn", d, d / "out", timeout=120)
    return inputs, [load_rank(d / "out", "bn", r) for r in range(2)]


def _world1(inputs):
    bn = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(inputs[name]))
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = _batch_norm(bn, x, True, True)
    (y * torch.from_numpy(inputs["gy"])).sum().backward()
    return bn, x, y


def test_global_batch_norm_at_world_two_equals_world_one(bn_run):
    inputs, ranks = bn_run
    bn, x, y = _world1(inputs)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    # the backward of the statistics crosses the ranks
    np.testing.assert_allclose(np.concatenate([r["gx"] for r in ranks]), x.grad.numpy(),
                               rtol=RTOL, atol=ATOL)
    for name in ("gweight", "gbias"):  # each rank's share; the step sums them
        want = getattr(bn, name[1:]).grad.numpy()
        np.testing.assert_allclose(ranks[0][name] + ranks[1][name], want, rtol=RTOL, atol=1e-4)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
        np.testing.assert_allclose(ranks[0][name], getattr(bn, name).numpy(), rtol=RTOL, atol=ATOL)


def test_global_batch_norm_rows_and_gather(bn_run):
    _, ranks = bn_run
    assert ranks[0]["rows"].tolist() == [0, 1, 2, 3] and ranks[1]["rows"].tolist() == [4, 5, 6, 7]
    full = np.concatenate([r["y"] for r in ranks])
    for r in ranks:
        np.testing.assert_array_equal(r["y_gathered"], full)


def test_global_batch_norm_equals_flax_s_on_a_two_device_mesh(bn_run):
    inputs, ranks = bn_run
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": inputs["weight"], "bias": inputs["bias"]},
                 "batch_stats": {"mean": inputs["running_mean"], "var": inputs["running_var"]}}
    x = jnp.asarray(inputs["x"].transpose(0, 2, 3, 1))
    gy = jnp.asarray(inputs["gy"].transpose(0, 2, 3, 1))

    def f(v, x):
        y, upd = bn.apply(v, x, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    def g(v, x):
        return jax.grad(lambda x: jnp.sum(f(v, x)[0] * gy))(x)

    m = Mesh(np.array(jax.devices()[:2]), ("data",))
    rep, dat = NamedSharding(m, P()), NamedSharding(m, P("data"))
    y, stats = jax.jit(f, in_shardings=(rep, dat), out_shardings=(dat, rep))(variables, x)
    gx = jax.jit(g, in_shardings=(rep, dat), out_shardings=dat)(variables, x)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               np.asarray(y).transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.concatenate([r["gx"] for r in ranks]),
                               np.asarray(gx).transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["running_mean"], np.asarray(stats["mean"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["running_var"], np.asarray(stats["var"]), rtol=RTOL, atol=ATOL)
