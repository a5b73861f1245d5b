"""Each model family is a module of its own (families/<family>.py), found
by the configuration's `family`. Its readings are pinned: the MACs and
grids at the configurations' own sizes, and SHA-256 digests of the seed-0
initial state and of the float32 reference head of 2 frames at 64x96.
The head's digest is of one thread's arithmetic: torch's CPU convs add
in another order with other thread counts."""

import hashlib

import pytest
import torch

from yogo_bench import flops, manifest, reference, scene, weights

MAN = manifest.load()

PINNED = {
    "base_model": {
        "macs": 11_082_061_824, "grid": (129, 97),
        "weights": "239fff744eac2e88a5a313b231f02d48b8df22bd36ecbc5370f6fc3a0c5b6cac",
        "head": "5773733c0fe3460f34f0eb4d6559d451253a3385661f95f3ba847058648304d5",
    },
    "convnext_small": {
        "macs": 136_192_365_120, "grid": (128, 96),
        "weights": "ef6a1e2bd7ccdfe4ddc2593d8753cb8dab14785202749fe7fa821a71e4254143",
        "head": "b1b3559d1f9e0d3b8f8696a7a49f757678b5e66fc09597ebb43f442f46f31323",
    },
}


def digest(tensors: dict) -> str:
    """SHA-256 of {name: tensor} in name order: each name, then its bytes."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(PINNED))
def test_macs_and_grid_are_pinned(config):
    cfg = manifest.config(MAN, config)
    assert flops.macs_per_image(cfg) == PINNED[config]["macs"]
    assert reference.grid(cfg) == PINNED[config]["grid"]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_seed0_weights_are_pinned(config):
    cfg = manifest.config(MAN, config)
    w = weights.make(manifest.family(cfg["family"]).spec(cfg), 0, "cpu")
    assert digest(w) == PINNED[config]["weights"]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_reference_head_is_pinned(config, one_thread):
    cfg = {**manifest.config(MAN, config), "img_size": [64, 96]}
    w = weights.make(manifest.family(cfg["family"]).spec(cfg), 0, "cpu")
    frames, _ = scene.pool(0, range(2), hw=cfg["img_size"], blobs=(2, 5))
    head = reference.head(w, frames, cfg)
    assert head.dtype == torch.float32 and head.shape == (2, *reference.grid(cfg)[::-1], 7)
    assert hashlib.sha256(head.contiguous().numpy().tobytes()).hexdigest() == PINNED[config]["head"]


def test_a_family_without_a_training_path_refuses_one():
    cfg = {**manifest.config(MAN, "convnext_small"), "img_size": [64, 96]}
    fam = manifest.family(cfg["family"])
    w = weights.make(fam.spec(cfg), 0, "cpu")
    with pytest.raises(NotImplementedError):
        fam.forward(w, torch.zeros(1, 1, 64, 96), cfg, cast=reference.f32, train=True)
