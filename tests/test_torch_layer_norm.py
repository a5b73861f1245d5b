"""The LayerNorm kernel (yogo_tpu_torch/csrc/layer_norm.cu via
ops/layer_norm.layer_norm_cuda) against its plain version
(models/yogo.layer_norm, flax's formula as a chain of torch ops), and the
module (models/yogo.LayerNorm) that chooses between them.

The CPU tests check what runs here: the wrapper's refusals (on `meta`
tensors, which no kernel takes, and on a CPU tensor), the plan of lanes a
row, and the module's plain path (equal to
`layer_norm(...).to(dtype)` bit for bit, no launch, gradients). The `cuda`
tests need a GPU:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layer_norm.py -m cuda
This file imports no JAX.

Tolerances on the card (kernel against the plain version there): the two
compute the same f32 operations in the same order except the sums, which
the kernel takes over a lane's chunks and then a shuffle tree where torch
takes its own reduction order. That moves mean and var by a few f32 ulps
(relative 1e-6 at the sums' scale), so f32 outputs of order 1-5 agree
within 1e-5; a bf16 output then rounds the other way only where the f32
value lies within that distance of a rounding boundary: one bf16 ulp
(2^-7 of the value at most), in a small share of the elements.
"""

import math

import numpy as np
import pytest
import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.models import yogo as Y
from yogo_tpu_torch.ops import layer_norm as L
from yogo_tpu_torch.utils import tracing

TRUNK_WIDTHS = (96, 192, 384, 768, 1536)
DTYPES = (torch.bfloat16, torch.float32)
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value, at most
BF16_SHARE = 0.01  # of the elements that may differ by that ulp


def launches() -> int:
    return tracing.COUNTS["layer_norm_kernel_launches"]


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("c,out,want", [
    (96, torch.bfloat16, (4, 3)), (192, torch.bfloat16, (8, 3)), (384, torch.bfloat16, (16, 3)),
    (768, torch.bfloat16, (32, 3)), (1536, torch.bfloat16, (32, 6)), (8, torch.bfloat16, (1, 1)),
    (56, torch.bfloat16, (1, 7)), (1528, torch.bfloat16, (32, 6)),
    (96, torch.float32, (8, 3)), (768, torch.float32, (32, 6)), (1536, torch.float32, (32, 12)),
    (8, torch.float32, (2, 1)),
])
def test_plan_of_lanes_a_row(c, out, want):
    assert L.plan(c, out) == want


@pytest.mark.parametrize("out", DTYPES)
def test_plan_covers_every_width_and_idles_no_lane_at_the_trunks(out):
    vec = L.chunk(out)
    assert vec * out.itemsize == 16
    for c in range(8, L.MAX_C + 1, 8):
        tpr, ch = L.plan(c, out)
        assert tpr in (1, 2, 4, 8, 16, 32) and 1 <= ch * vec <= L.MAX_ELEMS and tpr * ch * vec >= c, c
    for c in TRUNK_WIDTHS:
        tpr, ch = L.plan(c, out)
        assert tpr * ch * vec == c


def test_layer_norm_variants_edit_the_current_source():
    """Every text edit of the variant-timing script still finds its anchor
    exactly once in csrc/layer_norm.cu, the kernel variant is the source,
    and its shapes add up to the trunks' 40 and 53 launches."""
    from yogo_tpu_torch.tools import layer_norm_variants as v
    from yogo_tpu_torch.tools.timing import variant_source

    src = (kernels.CSRC_DIR / "layer_norm.cu").read_text()
    assert variant_source(src, v.VARIANTS["kernel"][0]) == src
    for name, (edits, _) in v.VARIANTS.items():
        assert variant_source(src, edits) != src or name == "kernel"
    for trunk, want in (("convnext_small", 40), ("swin_small", 53)):
        assert sum(s[4].get(trunk, 0) for s in v.SHAPES) == want


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _args(c=96, **over):
    a = {"x": _meta((4, 5, c)), "weight": _meta((c,), torch.float32), "bias": _meta((c,), torch.float32),
         "out_dtype": torch.bfloat16}
    a.update(over)
    return a


WRONG = {
    "x_f16": ({"x": _meta((4, 5, 96), torch.float16)}, "x must be bfloat16 or float32"),
    "x_f64": ({"x": _meta((4, 5, 96), torch.float64)}, "x must be bfloat16 or float32"),
    "out_f16": ({"out_dtype": torch.float16}, "output dtype must be"),
    "c_not_multiple_of_8": (_args(c=100), "C must be a multiple of 8"),
    "c_4": (_args(c=4), "C must be a multiple of 8"),
    "c_above_1536": (_args(c=1544), "C must be a multiple of 8 in"),
    "rows_not_contiguous": ({"x": _meta((5, 4, 96)).transpose(0, 1)}, "x must be contiguous"),
    "channels_strided": ({"x": _meta((4, 5, 192))[..., ::2]}, "x must be contiguous"),
    "weight_bf16": ({"weight": _meta((96,), torch.bfloat16)}, "weight must be a contiguous"),
    "bias_short": ({"bias": _meta((88,), torch.float32)}, "bias must be a contiguous"),
    "weight_on_cpu": ({"weight": torch.ones(96)}, "one device"),
    "meta": ({}, "no LayerNorm kernel for device meta"),
    "cpu": ({"x": torch.zeros(4, 5, 96, dtype=torch.bfloat16), "weight": torch.ones(96),
             "bias": torch.zeros(96)}, "no LayerNorm kernel for device cpu"),
}


@pytest.mark.parametrize("case", sorted(WRONG))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    over, match = WRONG[case]
    a = {**_args(), **over}
    before = launches()
    with pytest.raises(ValueError, match=match):
        L.layer_norm_cuda(a["x"], a["weight"], a["bias"], 1e-6, a["out_dtype"])
    assert launches() == before


def _norm(c, eps, seed=0) -> Y.LayerNorm:
    """A LayerNorm with seeded weight and bias (not the init's 1 / 0)."""
    g = torch.Generator().manual_seed(seed)
    m = Y.LayerNorm(c, eps)
    with torch.no_grad():
        m.weight.copy_(torch.rand(c, generator=g) + 0.5)
        m.bias.copy_(torch.randn(c, generator=g) * 0.5)
    return m


def _rows(shape, dtype, seed=1, mean=0.5, std=1.5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * std + mean).to(dtype)


@pytest.mark.parametrize("out", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("x_dtype", DTYPES)
def test_module_on_the_cpu_is_the_plain_chain_bit_for_bit(x_dtype, out):
    m = _norm(96, Y.LN_EPS)
    x = _rows((3, 7, 96), x_dtype)
    before = launches()
    got = m(x, out)
    want = Y.layer_norm(x, m.weight, m.bias, m.eps)
    want = want if out is None else want.to(out)
    assert got.dtype == (out or torch.float32)
    assert torch.equal(got, want)
    assert launches() == before


def test_module_under_autograd_takes_the_plain_chain_and_its_gradient_flows():
    m = _norm(192, Y.SWIN_LN_EPS)
    x = _rows((4, 192), torch.float32).requires_grad_()
    before = launches()
    m(x, torch.bfloat16).float().square().sum().backward()
    assert launches() == before
    xr = x.detach().clone().requires_grad_()
    w, b = (p.detach().clone().requires_grad_() for p in (m.weight, m.bias))
    Y.layer_norm(xr, w, b, m.eps).to(torch.bfloat16).float().square().sum().backward()
    for got, want in ((x.grad, xr.grad), (m.weight.grad, w.grad), (m.bias.grad, b.grad)):
        assert got is not None and torch.isfinite(got).all()
        assert torch.equal(got, want)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def plain(x, m, out):
    return Y.layer_norm(x, m.weight, m.bias, m.eps).to(out)


def assert_near_plain(got, want, out):
    """Within the tolerances of the module docstring: f32 to 1e-5; bf16 to
    one ulp, in at most 1% of the elements."""
    assert got.dtype == want.dtype == out and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    if out == torch.float32:
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)
        return
    torch.testing.assert_close(g, w, rtol=BF16_ULP, atol=F32_TOL)
    share = float((g != w).float().mean())
    assert share <= BF16_SHARE, share


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 1001, 50_003])
@pytest.mark.parametrize("out", DTYPES)
@pytest.mark.parametrize("x_dtype", DTYPES)
@pytest.mark.parametrize("c", TRUNK_WIDTHS)
def test_kernel_matches_the_plain_chain_at_the_trunks_widths(cuda, c, x_dtype, out, rows):
    """Every (C, input dtype, output dtype) of the two trunks; 1,001 rows
    fill no whole block (4-64 rows a block), 50,003 make the persistent
    grid walk the rows more than once."""
    m = _norm(c, Y.LN_EPS, seed=c).cuda()
    x = _rows((rows, c), x_dtype, seed=rows).cuda()
    before = launches()
    with torch.no_grad():
        got = m(x, out)
    assert launches() - before == 1
    assert_near_plain(got, plain(x, m, out), out)


@pytest.mark.cuda
@pytest.mark.parametrize("out", DTYPES)
@pytest.mark.parametrize("c", TRUNK_WIDTHS)
def test_constant_rows_clamp_the_variance_to_zero(cuda, c, out):
    """x = const: the sums are exact, so mean is the value, var clamps to
    0 and x - mean is 0: the output is the bias, rounded once. The plain
    chain's mean (its sum times a rounded 1/C) may be an ulp off the value,
    which rsqrt(eps) scales: it agrees within a few such ulps."""
    m = _norm(c, Y.SWIN_LN_EPS, seed=3).cuda()
    x = torch.full((257, c), 0.75, device="cuda")
    x[100:] = -3.0
    with torch.no_grad():
        got = L.layer_norm_cuda(x, m.weight, m.bias, m.eps, out)
    assert torch.equal(got, m.bias.detach().to(out).expand(257, c))
    atol = 4 * 2.0 ** -22 / math.sqrt(m.eps) * float(m.weight.detach().max())  # 4 ulps of |x| <= 3
    torch.testing.assert_close(got.float(), plain(x, m, out).float(),
                               rtol=BF16_ULP if out == torch.bfloat16 else 0.0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", DTYPES)
@pytest.mark.parametrize("c", TRUNK_WIDTHS)
def test_rows_with_a_large_mean_cancel_as_the_plain_chain_does(cuda, c, x_dtype):
    """Rows of mean 32 and spread 1: the fast variance E[x^2] - mean^2
    cancels ~10 of f32's 24 bits, and each sum's order then moves var by
    ~sqrt(C) ulps of E[x^2] (~1e3 of var). The kernel takes that formula,
    as the plain chain does: the two agree within what that cancellation
    allows, 8 sqrt(C) 2^-24 mean^2 / var relatively, and the kernel's
    output stays within the same distance of the exact float64 one."""
    m = _norm(c, Y.LN_EPS, seed=5).cuda()
    x = _rows((4096, c), x_dtype, seed=9, mean=32.0, std=1.0).cuda()
    with torch.no_grad():
        got = L.layer_norm_cuda(x, m.weight, m.bias, m.eps, torch.float32)
    want = plain(x, m, torch.float32)
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    var = xd.var(-1, unbiased=False, keepdim=True)
    exact = (xd - mean) / torch.sqrt(var + m.eps) * m.weight.double() + m.bias.double()
    tol = 8 * math.sqrt(c) * 2.0 ** -24 * float((mean.square() / var).max())
    # the output's own size plus one spread's worth (the mean's error is
    # relative to the spread, not to x - mean)
    scale = ((xd - mean).abs() + var.sqrt()) / torch.sqrt(var + m.eps) * m.weight.double().abs()
    assert float(((got.double() - want.double()).abs() / scale).max()) <= tol
    assert float(((got.double() - exact).abs() / scale).max()) <= tol


@pytest.mark.cuda
def test_kernel_follows_the_current_stream_and_refuses_misaligned_rows(cuda):
    m = _norm(384, Y.LN_EPS).cuda()
    x = _rows((999, 384), torch.bfloat16).cuda()
    want = plain(x, m, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        got = L.layer_norm_cuda(x, m.weight, m.bias, m.eps, torch.bfloat16)
    side.synchronize()
    assert_near_plain(got, want, torch.bfloat16)
    flat = torch.zeros(8 + 384 * 4, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        L.layer_norm_cuda(flat[4:4 + 384 * 4].view(4, 384), m.weight.detach(), m.bias.detach(), m.eps)


@pytest.mark.cuda
def test_launch_refuses_a_plan_that_does_not_cover_the_row(cuda):
    """The C launcher checks the plan it is handed and launches nothing on
    one it cannot run: kernels.launch raises, naming the error."""
    x = torch.zeros(16, 96, device="cuda")
    w, b = torch.ones(96, device="cuda"), torch.zeros(96, device="cuda")
    y = torch.empty_like(x)
    for tpr, ch, ok in ((8, 3, True), (4, 6, True), (4, 3, False), (3, 8, False), (64, 1, False),
                        (1, 17, False)):
        before = launches()
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 16, 96, 0, 0, tpr, ch, 1e-6)
        if ok:
            kernels.launch("layer_norm", x.device, *args)
        else:
            with pytest.raises(RuntimeError, match="invalid argument"):
                kernels.launch("layer_norm", x.device, *args)
        assert launches() - before == int(ok), (tpr, ch)


@pytest.mark.cuda
def test_module_under_autograd_on_the_card_takes_the_plain_chain(cuda):
    m = _norm(768, Y.LN_EPS).cuda()
    x = _rows((64, 768), torch.float32).cuda().requires_grad_()
    before = launches()
    y = m(x, torch.bfloat16)
    assert launches() == before and y.grad_fn is not None
    y.float().sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(m.weight.grad).all()
    with torch.no_grad():
        m(x, torch.bfloat16)
    with torch.inference_mode():
        m(x.detach(), torch.bfloat16)
    assert launches() - before == 2


def _seeded_norms(net: torch.nn.Module, seed: int) -> None:
    """LayerNorm weights and biases (and ConvNeXt's layer scale) away from
    their init, so that every one matters to the head."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, Y.LayerNorm):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
            if isinstance(mod, Y.ConvNeXtBlock):
                mod.gamma.fill_(0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("version,hw,want", [("convnext_small", (128, 160), 40), ("swin_small", (100, 132), 53)])
def test_a_trunk_forward_launches_one_kernel_a_layer_norm(cuda, monkeypatch, version, hw, want):
    """A bf16 forward of each trunk at a small frame size: 40 (ConvNeXt:
    stem, 36 blocks, 3 downsamples) and 53 (Swin: stem, 2 in each of 24
    blocks, 3 merges, final) launches. Its head is as close to the float32
    forward's (plain chain, TF32 off) as the bf16 forward with the plain
    chain in the kernel's place, and the two bf16 heads differ by no more
    than bf16's own noise: a bf16 ulp flipped in a few LayerNorm outputs
    flips roundings in every later Dense, so the two bf16 heads part by as
    much as two bf16 runs summed in different orders would (0.005 relative
    RMS at this size), not by the LayerNorm's own 1e-5."""
    model = Y.YOGO.create(hw, 0.08, 0.1, 2, model_version=version, compute_dtype=torch.bfloat16)
    net = model.init(torch.Generator().manual_seed(0), device="cuda")
    _seeded_norms(net, 1)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 1, *hw), np.uint8)).cuda()
    before = launches()
    got = model.apply(net, x, decode=False)
    assert launches() - before == want
    monkeypatch.setattr(Y, "layer_norm_cuda", lambda x, w, b, eps, dtype: Y.layer_norm(x, w, b, eps).to(dtype))
    plain_head = model.apply(net, x, decode=False)
    f32_head = model.with_compute_dtype(torch.float32).apply(net, x, decode=False)
    assert launches() - before == want

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    d_kernel, d_plain = rel(got, f32_head), rel(plain_head, f32_head)
    assert d_kernel <= 1.25 * d_plain, (d_kernel, d_plain)
    assert rel(got, plain_head) <= 2 * d_plain, (rel(got, plain_head), d_plain)
