"""The port's paired flips against the JAX package's: the flips themselves
exactly (they only move and negate float32 values), the two coins
statistically (torch's generator cannot reproduce jax.random's stream)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_loss import make_preds_labels
from yogo_tpu.data import transforms as jtransforms
from yogo_tpu_torch.data import transforms


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, 1, 24, 32), np.uint8)
    _, labels = make_preds_labels(seed, b=3, sy=3, sx=4, n_obj=5)
    return imgs, labels


@pytest.mark.parametrize("name", ["hflip", "vflip"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_flip_equals_jax_exactly(name, dtype):
    imgs, labels = _batch(1)
    imgs = imgs.astype(dtype)
    gi, gl = getattr(transforms, name)(torch.from_numpy(imgs), torch.from_numpy(labels))
    wi, wl = getattr(jtransforms, name)(jnp.asarray(imgs), jnp.asarray(labels))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert gi.dtype == torch.from_numpy(imgs).dtype
    # boxes stay well-formed and empty cells stay empty
    m = gl[:, 0] > 0
    assert int(m.sum()) == int((labels[:, 0] > 0).sum())
    assert (gl[:, 1][m] < gl[:, 3][m]).all() and (gl[:, 2][m] < gl[:, 4][m]).all()
    assert not gl[:, 1:][(~m)[:, None].expand(-1, 5, -1, -1)].any()


@pytest.mark.parametrize("do_h,do_v", [(False, False), (True, False), (False, True), (True, True)])
def test_apply_flips_is_the_jax_composition(do_h, do_v):
    imgs, labels = _batch(2)
    gi, gl = transforms.apply_flips(torch.from_numpy(imgs), torch.from_numpy(labels), do_h, do_v)
    wi, wl = jnp.asarray(imgs), jnp.asarray(labels)
    if do_h:
        wi, wl = jtransforms.hflip(wi, wl)
    if do_v:
        wi, wl = jtransforms.vflip(wi, wl)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_a_flip_is_its_own_inverse_up_to_one_rounding():
    imgs, labels = _batch(3)
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(labels)
    for f in (transforms.hflip, transforms.vflip):
        bi, bl = f(*f(ti, tl))
        np.testing.assert_array_equal(bi.numpy(), imgs)
        # 1 - (1 - x) rounds once in float32
        np.testing.assert_allclose(bl.numpy(), labels, rtol=0, atol=1.2e-7)


def test_the_flipped_box_covers_the_flipped_pixels():
    """A dark rectangle drawn at its label's box is found at the flipped
    label's box after the flip."""
    h, w, sy, sx = 24, 32, 3, 4
    imgs = np.full((1, 1, h, w), 200, np.uint8)
    imgs[0, 0, 2:8, 4:12] = 10
    labels = np.zeros((1, 6, sy, sx), np.float32)
    labels[0, :, 0, 1] = [1, 4 / w, 2 / h, 12 / w, 8 / h, 2]
    gi, gl = transforms.apply_flips(torch.from_numpy(imgs), torch.from_numpy(labels), True, True)
    (b, j, i), = np.argwhere(gl[:, 0].numpy() > 0)
    assert (j, i) == (sy - 1, sx - 2)
    x1, y1, x2, y2 = gl[0, 1:5, j, i].numpy()
    box = gi[0, 0, round(y1 * h) : round(y2 * h), round(x1 * w) : round(x2 * w)]
    assert box.numel() == 6 * 8 and (box == 10).all() and gl[0, 5, j, i] == 2
    assert int((gi == 10).sum()) == 48


def test_coins_one_per_axis_per_batch_fair_and_reproducible():
    g = torch.Generator().manual_seed(0)
    coins = np.array([transforms.flip_coins(g) for _ in range(4000)])
    # each coin is Bernoulli(0.5): 4000 draws put the mean within 4 sigma
    # (0.032) of 0.5, and the two axes are independent
    assert np.abs(coins.mean(axis=0) - 0.5).max() < 0.032
    assert abs(np.corrcoef(coins[:, 0], coins[:, 1])[0, 1]) < 0.06
    g2 = torch.Generator().manual_seed(0)
    again = np.array([transforms.flip_coins(g2) for _ in range(50)])
    np.testing.assert_array_equal(again, coins[:50])
    g3 = torch.Generator().manual_seed(1)
    rare = np.array([transforms.flip_coins(g3, p=0.1) for _ in range(4000)])
    assert np.abs(rare.mean(axis=0) - 0.1).max() < 0.02
    assert transforms.flip_coins(g3, p=0.0) == (False, False)
    assert transforms.flip_coins(g3, p=1.0) == (True, True)


def test_random_flips_flips_the_whole_batch_by_the_coins():
    imgs, labels = _batch(4)
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(labels)
    seen = set()
    for seed in range(40):
        coins = transforms.flip_coins(torch.Generator().manual_seed(seed))
        gi, gl = transforms.random_flips(torch.Generator().manual_seed(seed), ti, tl)
        wi, wl = transforms.apply_flips(ti, tl, *coins)
        np.testing.assert_array_equal(gi.numpy(), wi.numpy())
        np.testing.assert_array_equal(gl.numpy(), wl.numpy())
        seen.add(coins)
    assert len(seen) == 4
