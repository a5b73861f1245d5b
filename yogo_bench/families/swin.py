"""Swin-S as the trunk of YOGO (Liu et al. 2021, arXiv:2103.14030; the
widths of timm's swin_small_patch4_window7_224, the layout of the padded
detection backbone of Swin-Transformer-Object-Detection,
mmdet/models/backbones/swin_transformer.py): a 4x4 stride-4 patch
embedding + LayerNorm, four stages of shifted-window blocks with patch
merging between them, a final LayerNorm, and YOGO's 1x1 format conv and
4x4 stride-4 transpose conv as the head.

Written from the published code, in its own layout (windows batch-major,
(nW * B, w*w, C)), with attention's own softmax; it shares nothing with
the program. `attn_bytes` and `attn_flops` count the window attention's
work from the shapes, whatever implements it."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from yogo_bench.weights import Spec

MASK = -100.0  # the shift mask's additive logit between regions


def spec(cfg: dict) -> Spec:
    """Swin-S's weights as the configuration file states them (`init`):
    truncated-normal kernels of variance 1 / fan-in, biases normal with
    std init.bias_std, the relative-bias tables truncated normal with std
    init.rel_bias_std, LayerNorms 1 / 0, and the head's objectness set for
    production density (weights.production_density)."""
    init = cfg["init"]
    dims, depths, heads, ratio = cfg["dims"], cfg["depths"], cfg["heads"], cfg["mlp_ratio"]
    nout, patch, win = 5 + cfg["num_classes"], cfg["patch"], cfg["window"]
    bstd = init["bias_std"]
    out: Spec = []

    def dense(name, cout, cin, bias=True):
        out.append((f"{name}.weight", (cout, cin), "trunc", 1.0 / math.sqrt(cin)))
        if bias:
            out.append((f"{name}.bias", (cout,), "normal", bstd))

    def norm(name, d):
        out.extend([(f"{name}.weight", (d,), "const", 1.0), (f"{name}.bias", (d,), "const", 0.0)])

    out.append(("stem_conv.weight", (dims[0], 1, patch, patch), "trunc", 1.0 / math.sqrt(patch * patch)))
    out.append(("stem_conv.bias", (dims[0],), "normal", bstd))
    norm("stem_norm", dims[0])
    for s, (depth, d) in enumerate(zip(depths, dims)):
        if s > 0:
            norm(f"merge{s}.norm", 4 * dims[s - 1])
            dense(f"merge{s}.reduction", d, 4 * dims[s - 1], bias=False)
        for b in range(depth):
            p = f"stage{s}_block{b}"
            norm(f"{p}.attn_norm", d)
            dense(f"{p}.qkv", 3 * d, d)
            out.append((f"{p}.rel_bias", ((2 * win - 1) ** 2, heads[s]), "trunc", init["rel_bias_std"]))
            dense(f"{p}.proj", d, d)
            norm(f"{p}.mlp_norm", d)
            dense(f"{p}.fc1", ratio * d, d)
            dense(f"{p}.fc2", d, ratio * d)
    norm("final_norm", dims[-1])
    out.append(("format_conv.weight", (nout, dims[-1], 1, 1), "trunc", 1.0 / math.sqrt(dims[-1])))
    out.append(("format_conv.bias", (nout,), "normal", bstd))
    out.append(("format_up.weight", (nout, nout, 4, 4), "trunc", 1.0 / math.sqrt(nout * 16)))
    out.append(("format_up.bias", (nout,), "normal", bstd))
    return out


def _ln(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _dense(x, w, name, cast):
    return F.linear(cast(x), cast(w[f"{name}.weight"]), w.get(f"{name}.bias"))


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, win, win, C), as the published code."""
    b, h, w, c = x.shape
    x = x.view(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """The inverse of window_partition, as the published code."""
    b = windows.shape[0] // (h * w // win // win)
    x = windows.view(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_index(win: int) -> torch.Tensor:
    """(win^2, win^2): the relative-bias table's row that a query token
    reads for a key token, as the published WindowAttention builds it."""
    coords = torch.stack(torch.meshgrid([torch.arange(win), torch.arange(win)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


def shift_mask(hp: int, wp: int, win: int, shift: int, device) -> torch.Tensor:
    """(nW, win^2, win^2) of 0 and -100 over a padded (Hp, Wp) map, as the
    published BasicLayer builds it."""
    img_mask = torch.zeros((1, hp, wp, 1), device=device)
    slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, win).view(-1, win * win)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK).masked_fill(mask == 0, 0.0)


def attention(x, w, p, heads, win, mask, cast):
    """WindowAttention on (B * nW, win^2, C) tokens: qkv, scaled q . k
    plus the relative bias (and the mask), softmax, the values, proj."""
    bw, n, c = x.shape
    qkv = _dense(x, w, f"{p}.qkv", cast).reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = cast(q) @ cast(k).transpose(-2, -1)
    table = w[f"{p}.rel_bias"]
    bias = table[relative_index(win).to(table.device).view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.exp(attn - attn.amax(-1, keepdim=True))
    attn = attn / attn.sum(-1, keepdim=True)
    out = (attn @ cast(v)).transpose(1, 2).reshape(bw, n, c)
    return _dense(out, w, f"{p}.proj", cast)


def block(x, w, p, heads, win, shift, eps, cast):
    """SwinTransformerBlock of the detection backbone on (B, H, W, C)."""
    b, h, wd, c = x.shape
    t = _ln(x, w, f"{p}.attn_norm", eps)
    pad_r, pad_b = (win - wd % win) % win, (win - h % win) % win
    t = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, wd + pad_r
    if shift:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
    mask = shift_mask(hp, wp, win, shift, x.device) if shift else None
    t = attention(window_partition(t, win).view(-1, win * win, c), w, p, heads, win, mask, cast)
    t = window_reverse(t.view(-1, win, win, c), win, hp, wp)
    if shift:
        t = torch.roll(t, shifts=(shift, shift), dims=(1, 2))
    x = x + t[:, :h, :wd]
    y = F.gelu(_dense(_ln(x, w, f"{p}.mlp_norm", eps), w, f"{p}.fc1", cast))
    return x + _dense(y, w, f"{p}.fc2", cast)


def merge(x, w, p, eps, cast):
    """PatchMerging of the detection backbone: odd sides padded by one."""
    h, wd = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return _dense(_ln(x, w, f"{p}.norm", eps), w, f"{p}.reduction", cast)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, cast, train: bool = False,
            masks=None) -> torch.Tensor:
    """(B, 1, H, W) float32 pixels -> (B, Sy, Sx, 5+C) head: patch
    embedding + LayerNorm, the stages' blocks (every second one shifted
    by window // 2) with patch merging between them, the final LayerNorm,
    a 1x1 conv to 5+C and a 4x4 stride-4 transpose conv. No training
    path."""
    if train:
        raise NotImplementedError("the swin family has no training path")
    eps, win = cfg["ln_eps"], cfg["window"]
    h = F.conv2d(cast(x), cast(w["stem_conv.weight"]), w["stem_conv.bias"], cfg["patch"])
    h = _ln(h.permute(0, 2, 3, 1), w, "stem_norm", eps)
    for s, depth in enumerate(cfg["depths"]):
        if s > 0:
            h = merge(h, w, f"merge{s}", eps, cast)
        for b in range(depth):
            h = block(h, w, f"stage{s}_block{b}", cfg["heads"][s], win, win // 2 if b % 2 else 0, eps, cast)
    h = _ln(h, w, "final_norm", eps)
    y = F.conv2d(cast(h.permute(0, 3, 1, 2)), cast(w["format_conv.weight"]), w["format_conv.bias"])
    y = F.conv_transpose2d(cast(y), cast(w["format_up.weight"]), w["format_up.bias"], 4)
    return y.permute(0, 2, 3, 1)


def stage_maps(cfg: dict):
    """(h, w, hp, wp) of each stage's map: its tokens, and padded to whole
    windows."""
    h, w = cfg["img_size"]
    h, w = h // cfg["patch"], w // cfg["patch"]
    win = cfg["window"]
    out = []
    for s in range(len(cfg["depths"])):
        if s > 0:
            h, w = -(-h // 2), -(-w // 2)
        out.append((h, w, -(-h // win) * win, -(-w // win) * win))
    return out


def grid(cfg: dict) -> Tuple[int, int]:
    """(Sx, Sy): the last stage's map, upsampled 4x by the transpose conv."""
    h, w = stage_maps(cfg)[-1][:2]
    return 4 * w, 4 * h


def macs_per_image(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward: the patch embedding,
    the merges, qkv and proj on the padded windows' tokens, q . k and the
    values on the padded windows, the MLP on the map's tokens, the head."""
    dims, r, p, win = cfg["dims"], cfg["mlp_ratio"], cfg["patch"], cfg["window"]
    maps = stage_maps(cfg)
    total = maps[0][0] * maps[0][1] * dims[0] * p * p
    for s, ((h, w, hp, wp), depth, d) in enumerate(zip(maps, cfg["depths"], dims)):
        if s > 0:
            total += h * w * 4 * dims[s - 1] * d
        total += depth * (hp * wp * (4 * d * d + 2 * win * win * d) + h * w * 2 * r * d * d)
    h, w = maps[-1][:2]
    nout = 5 + cfg["num_classes"]
    total += h * w * nout * dims[-1]  # 1x1 format conv
    total += h * w * nout * nout * 16  # 4x4 stride-4 transpose: each input pixel feeds 16 outputs
    return total


def attn_bytes(cfg: dict, batch: int) -> int:
    """Bytes the window attention of a batch moves at least: each block's
    bf16 q, k and v of every padded window read once and its output
    written once, and each block's relative-bias table (bf16)."""
    win = cfg["window"]
    total = 0
    for (_, _, hp, wp), depth, d, heads in zip(stage_maps(cfg), cfg["depths"], cfg["dims"], cfg["heads"]):
        total += depth * (batch * hp * wp * d * 4 * 2 + (2 * win - 1) ** 2 * heads * 2)
    return total


def attn_flops(cfg: dict, batch: int) -> int:
    """FLOPs of the window attention of a batch: q . k and the weighted
    values, 4 * win^2 * C for each padded token and block."""
    win = cfg["window"]
    return sum(depth * batch * hp * wp * 4 * win * win * d
               for (_, _, hp, wp), depth, d in zip(stage_maps(cfg), cfg["depths"], cfg["dims"]))
