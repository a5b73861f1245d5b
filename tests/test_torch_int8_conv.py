"""The port's int8 conv (yogo_tpu_torch/ops/int8_conv.py) against the JAX
package's XLA s8 x s8 -> s32 conv (yogo_tpu/ops/quant.py `_conv`) and an
exact integer oracle on the CPU, and the CUDA kernel against its plain
version where a GPU is present.

JAX is imported inside the tests that compare with it, so the CUDA test
runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_conv.py -m cuda
Tolerances: integer accumulators and int8 codes exactly equal; f32 outputs
bit-equal for the identity and LeakyReLU epilogues (the same two roundings
as the JAX program's ops); SiLU within rtol 1e-6 and 2 ulp of the largest product (torch's
x / (1 + exp(-x)) against JAX's x * sigmoid(x)), and its requant codes
within 1.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from yogo_tpu_torch.ops import int8_conv as ic
from yogo_tpu_torch.utils import tracing

# (B, H, W, cin, cout, kernel, stride): odd H and W, C_in not a multiple of
# 32 (half_filters' 8 / 24), wide (256), C_out 7 (a quantized head) and 40;
# ConvNeXt's 2x2 stride-2 VALID downsample (an odd H / W drops its last
# row / column), padding (kernel - 1) // 2 throughout
CASES = [
    (2, 9, 11, 8, 16, 3, 1),
    (2, 9, 11, 24, 7, 3, 2),
    (1, 7, 5, 40, 40, 3, 2),
    (2, 6, 9, 256, 8, 1, 1),
    (1, 5, 6, 128, 130, 3, 1),
    (3, 3, 5, 24, 7, 3, 2),
    (2, 9, 11, 64, 48, 2, 2),
    (1, 8, 12, 192, 384, 2, 2),
]


def _case(seed, b, h, w, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    deq = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, w8, deq, bias


def _codes(x: np.ndarray) -> torch.Tensor:
    """int8 NHWC -> the kernel's codes, channels padded with zero codes."""
    cp = ic.padded_channels(x.shape[-1])
    return torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cp - x.shape[-1]))))


def _oracle(x, w8, stride, pad):
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    k = w8.shape[0]
    ho, wo = ic.out_hw(x.shape[1], x.shape[2], k, stride, pad)
    out = np.zeros((x.shape[0], ho, wo, w8.shape[-1]), np.int64)
    for i in range(ho):
        for j in range(wo):
            patch = xp[:, stride * i : stride * i + k, stride * j : stride * j + k, :]
            out[:, i, j] = np.tensordot(patch, w8.astype(np.int64), 3)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_accumulators_equal_jax_and_integer_oracle(case):
    import jax.numpy as jnp

    from yogo_tpu.models.defns import ConvSpec
    from yogo_tpu.ops import quant

    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, _, _ = _case(0, b, h, w, cin, cout, k)
    got = ic.conv_acc_reference(_codes(x), ic.pack_weights(w8), cin, s, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    spec = ConvSpec(cout, kernel=k, stride=s, padding=pad)
    want = np.asarray(quant._conv(jnp.asarray(x), jnp.asarray(w8), spec, jnp.int32))
    assert want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w8, s, pad))


@pytest.mark.parametrize("act", [None, "leaky_relu", "silu"])
@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "x".join(map(str, c)))
def test_plain_epilogue_and_requant_equal_the_jax_program(case, act):
    """f32 out: act(float(acc) * deq + b), as quantized_forward's lines
    612-614 compute it op by op (under jit XLA may contract the multiply-add
    into one FMA, a rounding fewer: within 1 ulp); int8 out: the next
    block's codes clip(round(h / s)) (:609-611) with zero codes in the
    padded channels."""
    import jax
    import jax.numpy as jnp

    from yogo_tpu.models.defns import ConvSpec
    from yogo_tpu.ops import quant

    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, deq, bias = _case(1, b, h, w, cin, cout, k)
    spec = ConvSpec(cout, kernel=k, stride=s, padding=pad, act=act)
    acc = quant._conv(jnp.asarray(x), jnp.asarray(w8), spec, jnp.int32)
    def epilogue(a):
        return quant._act_fn(act)(a.astype(jnp.float32) * deq + bias)

    want_h = np.asarray(epilogue(acc))
    scale = np.float32(np.abs(want_h).max() / 100.0)
    want_q = np.asarray(jnp.clip(jnp.round(want_h / scale), -127, 127).astype(jnp.int8))

    args = (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq), torch.from_numpy(bias))
    kw = dict(cin=cin, stride=s, padding=pad, act=act)
    got_h = ic.int8_conv(*args, **kw).numpy()
    got_q = ic.int8_conv(*args, **kw, out_scale=torch.tensor([scale])).numpy()
    assert got_h.shape == want_h.shape and got_h.dtype == np.float32
    # one rounding of the largest |float(acc) * deq| bounds what an FMA or
    # another SiLU formula moves (relative ulps blow up where h cancels to ~0)
    ulp = float(np.spacing(np.float32(np.abs(np.asarray(acc, np.float32) * deq).max())))
    if act == "silu":
        np.testing.assert_allclose(got_h, want_h, rtol=1e-6, atol=2 * ulp)
        assert np.abs(got_q[..., :cout].astype(int) - want_q).max() <= 1
    else:
        np.testing.assert_array_equal(got_h, want_h)
        np.testing.assert_array_equal(got_q[..., :cout], want_q)
        np.testing.assert_allclose(got_h, np.asarray(jax.jit(epilogue)(acc)), rtol=0, atol=ulp)
    assert got_q.shape[-1] == ic.padded_channels(cout) and not got_q[..., cout:].any()


def test_pack_weights_layout():
    w8 = np.arange(3 * 3 * 5 * 2, dtype=np.int64).reshape(3, 3, 5, 2).astype(np.int8)
    p = ic.pack_weights(w8)
    assert p.shape == (2, 3, 3, 32) and p.dtype == torch.int8 and p.is_contiguous()
    np.testing.assert_array_equal(p[..., :5].numpy(), w8.transpose(3, 0, 1, 2))
    assert not p[..., 5:].any()
    with pytest.raises(ValueError, match="int8"):
        ic.pack_weights(w8.astype(np.float32))


def test_cpu_wrapper_takes_plain_version_without_launching():
    x, w8, deq, bias = _case(2, *CASES[0][:5], 3)
    args = (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq), torch.from_numpy(bias))
    before = tracing.COUNTS["int8_conv_kernel_launches"]
    got = ic.int8_conv(*args, cin=8, stride=1, padding=1, act="leaky_relu")
    want = ic.int8_conv_reference(*args, cin=8, stride=1, padding=1, act="leaky_relu")
    assert torch.equal(got, want) and tracing.COUNTS["int8_conv_kernel_launches"] == before


@pytest.mark.parametrize(
    "change,err,match",
    [
        (dict(act="gelu"), NotImplementedError, "activation"),
        (dict(stride=3), ValueError, "built for"),
        (dict(padding=0), ValueError, "built for"),
        (dict(cin=40), ValueError, "channels"),
        (dict(q=torch.zeros((1, 4, 4, 8), dtype=torch.int8)), ValueError, "multiple of 32"),
        (dict(q=torch.zeros((1, 4, 4, 32))), ValueError, "int8"),
        (dict(deq=torch.zeros(3)), ValueError, "deq"),
        (dict(bias=torch.zeros(16, dtype=torch.float64)), ValueError, "bias"),
        (dict(out_scale=torch.ones(2)), ValueError, "out_scale"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err, match):
    kw = dict(q=torch.zeros((1, 4, 4, 32), dtype=torch.int8),
              w_packed=torch.zeros((16, 3, 3, 32), dtype=torch.int8),
              deq=torch.ones(16), bias=torch.zeros(16), cin=8, stride=2, padding=1,
              act="leaky_relu", out_scale=None)
    kw.update(change)
    with pytest.raises(err, match=match):
        ic.int8_conv(**kw)


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


# the base_model blocks 4-6 at a reduced size, ragged M tiles, odd shapes;
# ConvNeXt-Small's site shapes at a reduced size (C_in and C_out up to
# 3,072, a ragged N tile at C_out 96, the 2x2 stride-2 downsample)
CUDA_CASES = CASES + [
    (4, 97, 129, 128, 128, 3, 1),
    (4, 193, 258, 128, 128, 3, 2),
    (1, 3, 5, 8, 8, 3, 2),
    (2, 17, 33, 384, 384, 3, 1),
    (2, 24, 32, 384, 1536, 1, 1),
    (2, 12, 16, 3072, 768, 1, 1),
    (2, 6, 8, 768, 3072, 1, 1),
    (2, 24, 32, 384, 96, 1, 1),
    (2, 48, 65, 384, 768, 2, 2),
    # many times more tiles than SMs (3,129 of 64 rows); a K tail at 1x1
    # (Cp 32: a quarter of a stage; Cp 416: 3.25 stages); f32 Cout 7 (rows
    # TMA cannot store) over many tiles; each (kernel, stride, padding) at B=1
    (16, 97, 129, 128, 128, 3, 1),
    (2, 24, 32, 32, 64, 1, 1),
    (2, 12, 16, 416, 128, 1, 1),
    (4, 40, 50, 128, 7, 3, 1),
    (1, 17, 23, 64, 96, 3, 1),
    (1, 17, 23, 64, 96, 3, 2),
    (1, 17, 23, 256, 256, 1, 1),
    (1, 17, 23, 192, 384, 2, 2),
    # ConvNeXt-Small's int8 sites on the row shards of a 772x1032 batch of
    # 4 (parallel/spatial.py): stage 0's 97 / 49-row shards (N = 2 / 4, odd
    # M), stage 1's and 3's at N = 4, and the downsamples' 2x2 stride-2
    # windows of 24 rows over an odd W of 129 and of 12 rows
    (4, 97, 258, 384, 96, 1, 1),
    (4, 49, 258, 384, 96, 1, 1),
    (4, 24, 129, 192, 768, 1, 1),
    (4, 24, 129, 768, 192, 1, 1),
    (4, 6, 32, 768, 3072, 1, 1),
    (4, 24, 129, 192, 384, 2, 2),
    (4, 12, 64, 384, 768, 2, 2),
]


# the main path's sites at 772x1032 (B=64): base_model blocks 4, 5 / 6;
# ConvNeXt-Small's stage-1 / stage-2 / stage-3 pointwise pairs and its
# downsamples (an odd W of 129 before down2 drops its last column)
FULL_SIZE_CASES = [
    (64, 193, 258, 128, 128, 3, 2),
    (64, 97, 129, 128, 128, 3, 1),
    (64, 96, 129, 192, 768, 1, 1),
    (64, 96, 129, 768, 192, 1, 1),
    (64, 48, 64, 384, 1536, 1, 1),
    (64, 48, 64, 1536, 384, 1, 1),
    (64, 24, 32, 768, 3072, 1, 1),
    (64, 24, 32, 3072, 768, 1, 1),
    (64, 96, 129, 192, 384, 2, 2),
    (64, 48, 64, 384, 768, 2, 2),
    (64, 193, 258, 96, 192, 2, 2),
]


def _ids(c):
    return "x".join(map(str, c))


@pytest.mark.parametrize("out_s8", [False, True], ids=["f32", "s8"])
@pytest.mark.parametrize("case", CASES + CUDA_CASES + FULL_SIZE_CASES, ids=_ids)
def test_plan_covers_every_output_once(case, out_s8):
    """The grid's blocks, walking their tiles as the kernel does, write
    every output row and channel exactly once; the shared-memory layout
    fits the card and keeps the swizzled tiles 1 KiB-aligned."""
    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    cp = ic.padded_channels(cin)
    plan = ic.launch_plan(b, h, w, cp, cout, k, s, pad, out_s8=out_s8)
    ho, wo = ic.out_hw(h, w, k, s, pad)
    m, cols = b * ho * wo, ic.padded_channels(cout) if out_s8 else cout
    rows = np.zeros((m, plan.n_tiles), np.int64)  # each (row, N tile) once
    col_cover = np.zeros(cols, np.int64)
    walked, per_block, n_of_block = 0, {}, {}
    for cta, consumer, m0, n0 in ic.plan_tiles(plan):
        j = per_block.setdefault(cta, 0)
        assert consumer == j % plan.consumers and n_of_block.setdefault(cta, n0) == n0  # one N tile a block
        per_block[cta] = j + 1
        assert 0 <= m0 < m and 0 <= n0 < cols and m0 % plan.block_m == 0 and n0 % plan.block_n == 0
        rows[m0:m0 + plan.block_m, n0 // plan.block_n] += 1
        if m0 == 0:
            col_cover[n0:n0 + plan.block_n] += 1
        walked += 1
    assert walked == plan.tiles == plan.m_tiles * plan.n_tiles
    assert (rows == 1).all() and (col_cover == 1).all()
    assert len(per_block) == plan.grid <= ic.H100_SMS and plan.grid % plan.n_tiles == 0
    assert plan.consumers == (3 if plan.block_n == 128 else 2)
    assert ic.launch_plan(b, h, w, cp, cout, k, s, pad, out_s8=out_s8, act="silu").consumers == 2
    assert plan.grid // plan.n_tiles == max(1, min(ic.H100_SMS // plan.n_tiles, -(-plan.m_tiles // plan.consumers)))
    # shared memory: regions in order, aligned, within the opt-in limit
    assert plan.block_m == 64 and plan.block_n in (128, 256) and plan.k_blocks == k * k * -(-cp // 128)
    assert plan.block_n == (256 if cout % 256 == 0 and not out_s8 else 128)
    ends = [plan.b_offset, plan.ring_offset, plan.epi_offset, plan.vec_offset, plan.bar_offset]
    assert ends == sorted(ends) and all(e % ic.SMEM_ALIGN == 0 for e in ends)
    assert plan.ring_offset - plan.b_offset == plan.resident_b * plan.k_blocks * plan.b_chunk_bytes
    assert plan.epi_offset - plan.ring_offset == plan.stages * plan.ring_stage_bytes
    assert plan.smem_bytes == ic.SMEM_ALIGN + plan.bar_offset + ic.BARRIER_BYTES <= ic.SMEM_LIMIT
    # a consumer keeps one k-block of products running while another slot loads
    assert 2 <= plan.stages <= ic.MAX_STAGES and (2 * plan.stages + 1 + plan.consumers) * 8 <= ic.BARRIER_BYTES
    assert plan.resident_b in (0, 1)
    assert plan.store == ic.STORES["tma" if out_s8 or cout % 4 == 0 else "direct"]
    arr = plan.to_array()
    assert plan.bar_offset - plan.vec_offset == plan.consumers * 2 * plan.block_n * 4
    assert arr.dtype == np.int32 and arr.shape == (ic.PLAN_LEN,) == (27 + 2 * ic.MAX_TAPS,)


def test_plan_choices_at_the_main_path_sites():
    """base_model's blocks keep their whole weight tile resident beside a
    6-deep A ring; ConvNeXt's Cout 1,536 takes N tiles of 256 and keeps each
    block's resident; pwconv2's (192 KB) streams through the ring."""
    blk = ic.launch_plan(64, 97, 129, 128, 128, 3, 1, 1, out_s8=True)
    assert (blk.block_m, blk.block_n, blk.resident_b, blk.stages, blk.k_blocks) == (64, 128, 1, 6, 9)
    assert (blk.tiles, blk.grid, blk.route, blk.epi_bufs, blk.consumers) == (12513, 132, ic.ROUTES["im2col"], 1, 3)
    assert (blk.box_lower, blk.box_upper, blk.traversal_stride) == (-1, -1, 1)
    assert list(zip(blk.tap_dy, blk.tap_dx)) == [(dy, dx) for dy in range(3) for dx in range(3)]
    pw1 = ic.launch_plan(64, 48, 64, 384, 1536, 1, 1, 0, out_s8=False)
    assert (pw1.block_m, pw1.block_n, pw1.n_tiles, pw1.resident_b, pw1.route) == (64, 256, 6, 1, 0)
    assert pw1.grid == 132
    pw2 = ic.launch_plan(64, 48, 64, 1536, 384, 1, 1, 0, out_s8=False)
    assert (pw2.block_n, pw2.n_tiles, pw2.resident_b, pw2.stages, pw2.consumers) == (128, 3, 0, 7, 3)
    assert (pw1.k_blocks, pw1.store) == (3, ic.STORES["tma"])
    down = ic.launch_plan(64, 96, 129, 192, 384, 2, 2, 0, out_s8=False)
    assert (down.box_lower, down.box_upper, down.traversal_stride, down.chunks) == (0, -1, 2, 2)
    assert (down.resident_b, down.n_tiles, down.grid) == (1, 3, 132)
    assert (pw2.ring_offset, pw2.ring_stage_bytes) == (0, 64 * 128 + 128 * 128)
    # N tiles of 256 only for an f32 output that 256 divides
    assert ic.launch_plan(64, 48, 64, 384, 1536, 1, 1, 0, out_s8=True).block_n == 128
    assert ic.launch_plan(64, 48, 64, 384, 1408, 1, 1, 0, out_s8=False).block_n == 128
    small = ic.launch_plan(1, 3, 5, 32, 8, 3, 2, 1, out_s8=False, num_sms=132)
    assert small.tiles == 1 and small.grid == 1
    with pytest.raises(ValueError, match="no plan"):
        ic.launch_plan(1, 8, 8, 32, 8, 3, 3, 1, out_s8=False)


def _rn32(x: Fraction) -> np.float32:
    """The exact rational x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(np.asarray(c).view(np.int32)) & 1))


def _fma(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _kernel_div(h: np.float32, s: np.float32) -> np.float32:
    """csrc/int8_conv.cu div_by_scale in exact arithmetic: the IEEE
    reciprocal, h * inv, two FMA corrections; q0 past 2^22."""
    inv = _rn32(1 / Fraction(float(s)))
    q0 = _rn32(Fraction(float(h)) * Fraction(float(inv)))
    q1 = _fma(_fma(-s, q0, h), inv, q0)
    q2 = _fma(_fma(-s, q1, h), inv, q1)
    return q2 if abs(q0) < 4194304 else q0


def test_requant_division_is_the_correctly_rounded_quotient():
    """The kernel's branch-free h / s equals IEEE float32 division (what
    torch computes for int8_conv_reference) bit for bit: on random scales
    over 12 decades, quotients up to 300, near-ties (k + 0.5) * s a few ulps
    either side, and huge quotients; and so do the int8 codes."""
    rng = np.random.default_rng(11)
    s = np.float32(10.0) ** rng.uniform(-6, 6, 1500).astype(np.float32)
    q = rng.uniform(-300, 300, 1500).astype(np.float32)
    h = (q * s).astype(np.float32)
    k = rng.integers(-130, 130, 1500).astype(np.float32) + np.float32(0.5)
    ties = (k * s).astype(np.float32)
    nudge = rng.integers(-3, 4, 1500)
    for i, n in enumerate(nudge):
        for _ in range(abs(int(n))):
            ties[i] = np.nextafter(ties[i], np.float32(np.sign(n) * np.inf))
    huge = (rng.uniform(-1, 1, 200) * 1e30).astype(np.float32)
    hs = np.concatenate([h, ties, huge, np.float32([0.0, -0.0, 1e-30, -1e-30])])
    ss = np.concatenate([s, s, s[:200], s[:4]]).astype(np.float32)
    for hv, sv in zip(hs, ss):
        want = np.float32(hv) / np.float32(sv)
        got = _kernel_div(np.float32(hv), np.float32(sv))
        code = lambda v: int(np.clip(np.rint(v), -127, 127))
        assert code(got) == code(want), (hv, sv, got, want)
        if abs(want) < 4194304:  # the same float (a zero's sign aside: its code is 0 either way)
            assert got == want, (hv, sv, got, want)


def tma_im2col_load(x, *, c, w, h, n, off_w, off_h, lower, upper, stride, pixels, channels):
    """A TMA load in im2col mode (PTX ISA, tensor copies, im2col mode) from
    an NHWC tensor x (B, H, W, C), emulated pixel by pixel: the bounding box
    of base positions spans [lower, size - 1 + upper] in H and W; the
    traversal starts at (w, h, n), steps W by the traversal stride, wraps
    to the box's lower corner of the next row (H by the stride), then of
    the next image; pixel p reads (w_p + off_w, h_p + off_h), channels
    c .. c + channels - 1; whatever lies outside the tensor reads zero."""
    bsz, hh, ww, cc = x.shape
    out = np.zeros((pixels, channels), x.dtype)
    for p in range(pixels):
        yy, xx = h + off_h, w + off_w
        if 0 <= n < bsz and 0 <= yy < hh and 0 <= xx < ww and c < cc:
            seg = x[n, yy, xx, c:c + channels]
            out[p, :len(seg)] = seg
        w += stride
        if w > ww - 1 + upper:
            w, h = lower, h + stride
            if h > hh - 1 + upper:
                h, n = lower, n + 1
    return out


def tma_tiled_load(a, *, col, row, box_cols, box_rows):
    """A tiled TMA load of a box from a 2-D matrix, zero outside it."""
    out = np.zeros((box_rows, box_cols), a.dtype)
    blk = a[row:row + box_rows, col:col + box_cols]
    out[: blk.shape[0], : blk.shape[1]] = blk
    return out


def _a_matrix(x, k, stride, pad):
    """A of the implicit GEMM from F.unfold of the codes: (M, taps, Cp),
    row m the window of output pixel m, zero in the padding."""
    import torch.nn.functional as F

    t = torch.from_numpy(x).permute(0, 3, 1, 2).float()
    cols = F.unfold(t, k, padding=pad, stride=stride)  # (B, Cp * taps, L), (c, dy, dx) order
    b, _, length = cols.shape
    cols = cols.reshape(b, x.shape[-1], k * k, length).permute(0, 3, 2, 1)
    return cols.reshape(b * length, k * k, x.shape[-1]).numpy().astype(np.int8)


def _sample_tiles(plan, ho, wo, limit):
    """All tiles of a small case; of a large one the first, the last, those
    that cross an image boundary, and an even spread of the rest."""
    starts = list(range(0, plan.m_tiles * plan.block_m, plan.block_m))
    if len(starts) <= limit:
        return starts
    cross = [m0 for m0 in starts if m0 // (ho * wo) != (m0 + plan.block_m - 1) // (ho * wo)]
    spread = starts[:: max(1, len(starts) // limit)]
    return sorted(set([starts[0], starts[-1]] + cross[:limit] + spread))


@pytest.mark.parametrize("case", CASES + CUDA_CASES + FULL_SIZE_CASES, ids=_ids)
def test_plan_tma_loads_reproduce_unfold(case):
    """Each stage the kernel's producer loads for a tile (im2col for k > 1
    with the plan's corners, stride and tap offsets; a tiled box of the
    [M, Cp] codes for 1x1), emulated in numpy, is that tile's rows of A
    from F.unfold of the codes for its tap and 128-channel chunk: the zero
    fill at image edges, past the last image and past Cp included. Full
    size at B=2, so that tiles cross an image."""
    b, h, w, cin, cout, k, s = case
    b = min(b, 2)
    pad = (k - 1) // 2
    rng = np.random.default_rng(7)
    cp = ic.padded_channels(cin)
    x = np.zeros((b, h, w, cp), np.int8)
    x[..., :cin] = rng.integers(-127, 128, (b, h, w, cin))
    plan = ic.launch_plan(b, h, w, cp, cout, k, s, pad, out_s8=False)
    ho, wo = ic.out_hw(h, w, k, s, pad)
    a = _a_matrix(x, k, s, pad)
    m = a.shape[0]
    assert m == b * ho * wo
    for m0 in _sample_tiles(plan, ho, wo, 24):
        rows = np.zeros((plan.block_m, plan.taps, plan.chunks * ic.K_BLOCK), np.int8)
        n = min(plan.block_m, m - m0)
        rows[:n, :, :cp] = a[m0:m0 + n]
        base = ic.im2col_base(m0, ho, wo, s, pad)
        for t in range(plan.taps):
            for cc in range(plan.chunks):
                if plan.route == ic.ROUTES["im2col"]:
                    bw, bh, bn = base
                    got = tma_im2col_load(x, c=cc * ic.K_BLOCK, w=bw, h=bh, n=bn, off_w=plan.tap_dx[t],
                                          off_h=plan.tap_dy[t], lower=plan.box_lower, upper=plan.box_upper,
                                          stride=plan.traversal_stride, pixels=plan.block_m,
                                          channels=ic.K_BLOCK)
                else:
                    got = tma_tiled_load(x.reshape(-1, cp), col=cc * ic.K_BLOCK, row=m0,
                                         box_cols=ic.K_BLOCK, box_rows=plan.block_m)
                want = rows[:, t, cc * ic.K_BLOCK:(cc + 1) * ic.K_BLOCK]
                np.testing.assert_array_equal(got, want, err_msg=f"tile {m0} tap {t} chunk {cc}")


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "leaky_relu", "silu"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_kernel_equals_plain_version(cuda, case, act):
    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, deq, bias = _case(3, b, h, w, cin, cout, k)
    args = tuple(t.cuda() for t in (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq),
                                     torch.from_numpy(bias)))
    kw = dict(cin=cin, stride=s, padding=pad, act=act)
    scale = torch.tensor([0.05], device="cuda")
    for out_scale in (None, scale):
        n = tracing.COUNTS["int8_conv_kernel_launches"]
        got = ic.int8_conv(*args, **kw, out_scale=out_scale)
        torch.cuda.synchronize()
        assert tracing.COUNTS["int8_conv_kernel_launches"] == n + 1
        want = ic.int8_conv_reference(*args, **kw, out_scale=out_scale)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want), f"{case} {act} {out_scale is not None}"


def _cuda_args(case, seed):
    b, h, w, cin, cout, k, s = case
    x, w8, deq, bias = _case(seed, b, h, w, cin, cout, k)
    return tuple(t.cuda() for t in (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq),
                                     torch.from_numpy(bias)))


@pytest.mark.cuda
@pytest.mark.parametrize("out_s8", [False, True], ids=["f32", "s8"])
def test_cuda_tiles_of_128_and_256_channels_agree(cuda, out_s8):
    """Cout 1,536 with N tiles of 256 (the plan's choice for f32) and of 128
    (an int8 output), and Cout 1,408 (f32, N tiles of 128): each bit-equal
    to the plain version."""
    kw = dict(stride=1, padding=0, act="leaky_relu")
    out_scale = torch.tensor([0.05], device="cuda") if out_s8 else None
    for cout in (1536, 1408):
        args = _cuda_args((2, 24, 32, 384, cout, 1, 1), 4)
        plan = ic.launch_plan(2, 24, 32, 384, cout, 1, 1, 0, out_s8=out_s8, act="leaky_relu")
        assert plan.block_n == (256 if cout == 1536 and not out_s8 else 128)
        want = ic.int8_conv_reference(*args, cin=384, out_scale=out_scale, **kw)
        got = ic.int8_conv(*args, cin=384, out_scale=out_scale, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"Cout {cout}, block_n {plan.block_n}"


@pytest.mark.cuda
def test_cuda_entry_refuses_a_plan_that_does_not_fit_the_shape(cuda):
    import dataclasses

    args = _cuda_args((1, 9, 11, 64, 32, 3, 1), 5)
    plan = ic.launch_plan(1, 9, 11, 64, 32, 3, 1, 1, out_s8=False, num_sms=ic._sm_count(args[0].device))
    for bad in (dict(box_upper=0), dict(tap_dx=(1,) + plan.tap_dx[1:]), dict(stages=plan.stages + 9),
                dict(grid=plan.grid + 1), dict(stages=plan.stages - 1), dict(resident_b=0),
                dict(epi_bufs=3 - plan.epi_bufs)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            ic._launch(*args, None, stride=1, padding=1, act=None, plan=dataclasses.replace(plan, **bad))


def test_variants_edit_the_current_source():
    """Every text edit of the variant-timing script still finds its anchor
    exactly once in csrc/int8_conv.cu, and the kernel variant is the source."""
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.tools import int8_conv_variants as v
    from yogo_tpu_torch.tools.timing import variant_source

    src = (kernels.CSRC_DIR / "int8_conv.cu").read_text()
    assert variant_source(src, v.VARIANTS["kernel"][0]) == src
    for name, (edits, _, _) in v.VARIANTS.items():
        assert variant_source(src, edits) != src or name == "kernel"
    with pytest.raises(ValueError, match="anchor"):
        variant_source(src, [("no such line in the kernel", "")])
    assert set(v.FITS) <= set(v.VARIANTS)
    # private rings need two slots a consumer: not at down2_conv's 5-deep ring of 3
    fits = {site: v.FITS["private_rings"](ic.launch_plan(
        b, h, w, ic.padded_channels(cin), cout, k, s, (k - 1) // 2, out_s8=s8, act=act))
        for site, ((b, h, w, cin), cout, k, s, act, s8) in v.SITES.items()}
    assert fits == {"block4": True, "block5": True, "block6": True, "pwconv1": True, "pwconv2": True,
                    "down2_conv": False}


_PTXAS_LOG = """ptxas info    : Compiling entry function '_Z15int8_conv_kernelILi128ELi1ELb1EEv' for 'sm_90a'
ptxas info    : Function properties for _Z15int8_conv_kernelILi128ELi1ELb1EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1216 bytes cmem[0]
"""


def test_build_check_reads_ptxas_of_a_library_built_earlier(tmp_path, monkeypatch):
    """chip_smoke.py's phase-2 check of csrc/int8_conv.cu takes ptxas's
    report from beside the library, so it holds when an earlier process
    (the cuda tests, an earlier run) built the library and this one builds
    nothing; a library whose report is missing is built again."""
    import chip_smoke
    from yogo_tpu_torch import kernels

    log = tmp_path / "nvcc.log"
    log.write_text(_PTXAS_LOG)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done\ncat {log}\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(nvcc))
    kernels.build_all(["int8_conv"])  # the earlier process

    def no_nvcc():
        raise AssertionError("nvcc run for a library that is built")

    monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    sass = {"int8_conv": {"void int8_conv_kernel<128, 1, true>(...)": {"igmma": 4}}}
    out = chip_smoke.int8_conv_build_check(sass, 132)
    assert out["ptxas"]["_Z15int8_conv_kernelILi128ELi1ELb1EEv"]["registers"] == 128
    assert out["plans_at_sites"]["block5"]["stages"] == 6
    with pytest.raises(AssertionError, match="without IGMMA"):
        chip_smoke.int8_conv_build_check({"int8_conv": {"k": {"igmma": 0}}}, 132)
    log.write_text(_PTXAS_LOG.replace("0 bytes spill stores", "8 bytes spill stores"))
    kernels._log_path("int8_conv").unlink()
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(nvcc))
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.int8_conv_build_check(sass, 132)


def test_ptxas_summary_reads_registers_spills_and_shared_memory():
    from yogo_tpu_torch.kernels import ptxas_summary

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi128EEvv
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4stemv' for 'sm_90a'
ptxas info    : Function properties for _Z4stemv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 4608 bytes smem, 400 bytes cmem[0]
"""
    assert ptxas_summary(log) == {
        "_Z1kILi128EEvv": {"registers": 128, "smem": 0, "stack": 16, "spill_stores": 16, "spill_loads": 24},
        "_Z4stemv": {"registers": 40, "smem": 4608, "stack": 0, "spill_stores": 0, "spill_loads": 0},
    }
