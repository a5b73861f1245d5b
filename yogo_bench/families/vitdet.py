"""ViTDet-B as the trunk of YOGO (Li, Mao, Girshick and He 2022,
arXiv:2203.16527; detectron2 projects/ViTDet/configs/COCO/
mask_rcnn_vitdet_b_100ep.py, the backbone of
detectron2/modeling/backbone/vit.py and the stride-8 level of its
SimpleFeaturePyramid): a 16x16 stride-16 patch embedding plus the
absolute position embedding of a 224 / 16 grid with a class token
(get_abs_pos, bicubic), 12 blocks of width 768 and 12 heads, 14x14
windows but in the global blocks, every block with decomposed relative
positions (get_rel_pos, add_decomposed_rel_pos); no final norm; a 2x2
stride-2 transpose conv to half the width, a 1x1 conv and a 3x3 conv to
256 without bias, each with a channel LayerNorm; YOGO's 1x1 format conv
as the head.

Written from the published code, in its layout ((B * heads, L, L) logits
with the dense bias added, attention's own softmax, the tables resampled
every call), float32 (reference.head turns TF32 off around it); it shares
nothing with the program. The frame is zero-padded bottom and right to a
multiple of the patch, as detectron2's ImageList pads to its
size_divisibility. reference.head runs 8 images a block: a global block's
float32 logits are then 8 x 12 x 3,185^2 x 4 B = 3.9 GB at 772x1032.

`global_attn_bytes` and `global_attn_flops` count the global blocks'
attention from the shapes, whatever implements it: its q, k, v and
output in bf16 and its two tables, and 4 N^2 d + 2 N (h + w) d FLOPs a
head, image and block (q . k, the weighted values, the two rel-pos
products) over N = h x w tokens."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from yogo_bench.weights import Spec


def window_blocks(cfg: dict) -> List[int]:
    return list(cfg["window_block_indexes"])


def rel_size(cfg: dict, i: int) -> int:
    """The side a block's relative-position tables are made for: the
    window, or the published img_size over the patch in a global block."""
    return cfg["window"] if i in window_blocks(cfg) else cfg["vit_img_size"] // cfg["patch"]


def spec(cfg: dict) -> Spec:
    """ViTDet-B's weights as the configuration file states them (`init`):
    truncated-normal kernels of variance 1 / fan-in (a transpose conv's
    fan-in is its input channels: a 2x2 stride-2 one reads one tap of each
    for an output pixel) but the patch embedding's, of std init.stem_std
    (it reads 0-255 pixels), biases normal with std init.bias_std, the
    position embedding and the relative-position tables truncated normal
    with std init.pos_std and init.rel_pos_std, LayerNorms 1 / 0, and the
    format conv (the head) with its kernel's std scaled by init.head_scale
    and its bias the constant init.head_bias (the objectness at production
    density, with boxes of about the anchors' size)."""
    init = cfg["init"]
    dim, heads, ratio, p = cfg["embed_dim"], cfg["heads"], cfg["mlp_ratio"], cfg["patch"]
    neck, nout = cfg["neck_channels"], 5 + cfg["num_classes"]
    bstd = init["bias_std"]
    out: Spec = []

    def dense(name, cout, cin):
        out.append((f"{name}.weight", (cout, cin), "trunc", 1.0 / math.sqrt(cin)))
        out.append((f"{name}.bias", (cout,), "normal", bstd))

    def norm(name, d):
        out.extend([(f"{name}.weight", (d,), "const", 1.0), (f"{name}.bias", (d,), "const", 0.0)])

    grid = cfg["pretrain_img_size"] // p
    out.append(("stem_conv.weight", (dim, 1, p, p), "trunc", init["stem_std"]))
    out.append(("stem_conv.bias", (dim,), "normal", bstd))
    out.append(("pos_embed", (1, 1 + grid * grid, dim), "trunc", init["pos_std"]))
    for i in range(cfg["depth"]):
        b = f"block{i}"
        norm(f"{b}.attn_norm", dim)
        dense(f"{b}.qkv", 3 * dim, dim)
        for t in ("rel_pos_h", "rel_pos_w"):
            out.append((f"{b}.{t}", (2 * rel_size(cfg, i) - 1, dim // heads), "trunc", init["rel_pos_std"]))
        dense(f"{b}.proj", dim, dim)
        norm(f"{b}.mlp_norm", dim)
        dense(f"{b}.fc1", ratio * dim, dim)
        dense(f"{b}.fc2", dim, ratio * dim)
    out.append(("neck_up.weight", (dim, dim // 2, 2, 2), "trunc", 1.0 / math.sqrt(dim)))
    out.append(("neck_up.bias", (dim // 2,), "normal", bstd))
    out.append(("lateral_conv.weight", (neck, dim // 2, 1, 1), "trunc", 1.0 / math.sqrt(dim // 2)))
    norm("lateral_norm", neck)
    out.append(("output_conv.weight", (neck, neck, 3, 3), "trunc", 1.0 / math.sqrt(9 * neck)))
    norm("output_norm", neck)
    out.append(("format_conv.weight", (nout, neck, 1, 1), "trunc", init["head_scale"] / math.sqrt(neck)))
    out.append(("format_conv.bias", (nout,), "const", init["head_bias"]))
    return out


# ------------------------------------------------- detectron2 vit.py


def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) -> ((B * nW, w, w, C) windows, (Hp, Wp)), padded."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw, hw) -> torch.Tensor:
    """The inverse of window_partition, the padding cropped."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C): the table resampled (linear) to 2 max - 1
    rows where it has another length, read at each query and key's
    relative coordinate."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist,
            mode="linear",
        )
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """attn (B, q_h * q_w, k_h * k_w) plus rel_h[b, i, kh(j)] + rel_w[b,
    i, kw(j)], where rel_h = q . Rh and rel_w = q . Rw of the unscaled q."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
        B, q_h * q_w, k_h * k_w)
    return attn


def get_abs_pos(abs_pos: torch.Tensor, has_cls_token: bool, hw) -> torch.Tensor:
    """(1, h, w, C): the embedding without its class token, its square
    grid resampled bicubically to h x w where it has another size."""
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    xy_num = abs_pos.shape[1]
    size = int(math.sqrt(xy_num))
    if size * size != xy_num:
        raise ValueError("the position embedding is not a square grid")
    if size != h or size != w:
        new_abs_pos = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w),
            mode="bicubic",
            align_corners=False,
        )
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


# ------------------------------------------------------------ the model


def _ln(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _channel_ln(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float) -> torch.Tensor:
    """detectron2's LayerNorm of an NCHW map over its channels."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[f"{name}.weight"][:, None, None] * x + w[f"{name}.bias"][:, None, None]


def _dense(x, w, name, cast):
    return F.linear(cast(x), cast(w[f"{name}.weight"]), w.get(f"{name}.bias"))


def attention(x, w, p, heads, cast):
    """Attention with decomposed relative positions on (B, H, W, C)."""
    B, H, W, _ = x.shape
    qkv = _dense(x, w, f"{p}.qkv", cast).reshape(B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = (cast(q) * scale) @ cast(k).transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, cast(q), cast(w[f"{p}.rel_pos_h"]), cast(w[f"{p}.rel_pos_w"]),
                                  (H, W), (H, W))
    attn = attn.softmax(dim=-1)
    x = (attn @ cast(v)).view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    return _dense(x, w, f"{p}.proj", cast)


def block(x, w, p, heads, window, eps, cast):
    """Block: LayerNorm, window partition (window > 0), attention, window
    unpartition, residual; LayerNorm, MLP (exact GELU), residual."""
    shortcut = x
    x = _ln(x, w, f"{p}.attn_norm", eps)
    if window > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
    x = attention(x, w, p, heads, cast)
    if window > 0:
        x = window_unpartition(x, window, pad_hw, (H, W))
    x = shortcut + x
    y = F.gelu(_dense(_ln(x, w, f"{p}.mlp_norm", eps), w, f"{p}.fc1", cast))
    return x + _dense(y, w, f"{p}.fc2", cast)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, cast, train: bool = False,
            masks=None) -> torch.Tensor:
    """(B, 1, H, W) float32 pixels -> (B, Sy, Sx, 5+C) head: the frame
    padded to a multiple of the patch, the patch embedding plus the
    position embedding, the blocks, the pyramid's stride-8 level, the 1x1
    format conv. No training path."""
    if train:
        raise NotImplementedError("the vitdet family has no training path")
    p, eps, heads = cfg["patch"], cfg["ln_eps"], cfg["heads"]
    x = F.pad(x, (0, -x.shape[3] % p, 0, -x.shape[2] % p))
    h = F.conv2d(cast(x), cast(w["stem_conv.weight"]), w["stem_conv.bias"], stride=p).permute(0, 2, 3, 1)
    h = h + get_abs_pos(w["pos_embed"], True, (h.shape[1], h.shape[2]))
    for i in range(cfg["depth"]):
        window = cfg["window"] if i in window_blocks(cfg) else 0
        h = block(h, w, f"block{i}", heads, window, eps, cast)
    y = h.permute(0, 3, 1, 2)
    y = F.conv_transpose2d(cast(y), cast(w["neck_up.weight"]), w["neck_up.bias"], stride=2)
    y = _channel_ln(F.conv2d(cast(y), cast(w["lateral_conv.weight"])), w, "lateral_norm", eps)
    y = _channel_ln(F.conv2d(cast(y), cast(w["output_conv.weight"]), padding=1), w, "output_norm", eps)
    y = F.conv2d(cast(y), cast(w["format_conv.weight"]), w["format_conv.bias"])
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- counts


def token_map(cfg: dict) -> Tuple[int, int]:
    """(h, w): the patch embedding's map of the padded frame."""
    h, w = cfg["img_size"]
    return -(-h // cfg["patch"]), -(-w // cfg["patch"])


def grid(cfg: dict) -> Tuple[int, int]:
    """(Sx, Sy): the token map, upsampled 2x by the pyramid's transpose."""
    h, w = token_map(cfg)
    return 2 * w, 2 * h


def macs_per_image(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward: the patch embedding;
    in each block qkv and proj on its tokens (a window block's padded
    map), q . k and the weighted values at the head size, the rel-pos
    products (each query against the h + w rows of its tables), the MLP
    on the map's tokens; the pyramid's three convs and the head."""
    h, w = token_map(cfg)
    dim, r, p, win = cfg["embed_dim"], cfg["mlp_ratio"], cfg["patch"], cfg["window"]
    n = h * w
    total = n * dim * p * p
    for i in range(cfg["depth"]):
        if i in window_blocks(cfg):
            tokens, keys, side = (-(-h // win) * win) * (-(-w // win) * win), win * win, 2 * win
        else:
            tokens, keys, side = n, n, h + w
        total += tokens * (4 * dim * dim + 2 * keys * dim + side * dim) + n * 2 * r * dim * dim
    neck, nout, up = cfg["neck_channels"], 5 + cfg["num_classes"], dim // 2
    cells = 4 * n
    total += cells * dim * up  # 2x2 stride-2 transpose: each output pixel reads one tap of each channel
    total += cells * up * neck + cells * neck * neck * 9 + cells * neck * nout
    return total


def global_attn_bytes(cfg: dict, batch: int) -> int:
    """Bytes the global blocks' attention of a batch moves at least: each
    block's bf16 q, k, v read once and its output written once, and its
    two tables as the map reads them ((2h - 1) + (2w - 1) rows of the
    head size, bf16)."""
    h, w = token_map(cfg)
    d = cfg["embed_dim"] // cfg["heads"]
    blocks = cfg["depth"] - len(window_blocks(cfg))
    return blocks * (batch * h * w * cfg["embed_dim"] * 4 * 2 + (2 * h - 1 + 2 * w - 1) * d * 2)


def global_attn_flops(cfg: dict, batch: int) -> int:
    """FLOPs of the global blocks' attention of a batch: 4 N^2 d (q . k,
    the weighted values) + 2 N (h + w) d (the rel-pos products) a head,
    image and block, N = h x w tokens at the head size d."""
    h, w = token_map(cfg)
    n, d = h * w, cfg["embed_dim"] // cfg["heads"]
    blocks = cfg["depth"] - len(window_blocks(cfg))
    return blocks * batch * cfg["heads"] * (4 * n * n * d + 2 * n * (h + w) * d)
