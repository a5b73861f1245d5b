// Swin's shifted-window layout as two index maps, for the kernels that carry
// it (layer_norm.cu's windowed store, window_merge.cu's merge-add), so that
// no pass of their own copies the map.
//
// A block's map is (B, H, W, C), rows (b * H + i) * W + j. Its windows are the
// map zero-padded to (Hp, Wp) (multiples of `win`), rolled by -shift along
// both axes (torch.roll: rolled[i'] = padded[(i' + shift) mod Hp]) and cut
// into win x win windows, laid out token-major as (B, win*win, nW, C): slot
// row (b * win*win + t) * nW + n is token t = ty * win + tx (row-major in the
// window) of window n = ny * (Wp / win) + nx (row-major over the map), at
// rolled coordinates (ny * win + ty, nx * win + tx). That is
// models/yogo.window_partition after F.pad and torch.roll; its reverse is
// window_reverse, torch.roll by +shift and the crop to (H, W).

#pragma once

namespace yogo {

struct Windows {
  int H, W;      // the map
  int Hp, Wp;    // the padded map, multiples of win
  int win;       // window side
  int shift;     // the roll, 0 <= shift < win
};

// the map row that window slot `slot` holds, or -1 where it holds a padded
// zero (a source row or column past H or W)
__device__ __forceinline__ long long window_source(long long slot, const Windows& g) {
  const int nwx = g.Wp / g.win;
  const int nw = (g.Hp / g.win) * nwx;
  const long long per_image = (long long)g.Hp * g.Wp;
  const long long b = slot / per_image;
  const int r = (int)(slot - b * per_image);
  const int t = r / nw, n = r - t * nw;
  const int ty = t / g.win, tx = t - ty * g.win;
  const int ny = n / nwx, nx = n - ny * nwx;
  int i = ny * g.win + ty + g.shift, j = nx * g.win + tx + g.shift;
  if (i >= g.Hp) i -= g.Hp;
  if (j >= g.Wp) j -= g.Wp;
  if (i >= g.H || j >= g.W) return -1;
  return (b * g.H + i) * g.W + j;
}

// the window slot that map row `row` (i < H, j < W) was laid out in: the
// inverse of window_source on the rows it does not pad
__device__ __forceinline__ long long window_slot(long long row, const Windows& g) {
  const long long bi = row / g.W;
  const int j = (int)(row - bi * g.W);
  const long long b = bi / g.H;
  const int i = (int)(bi - b * g.H);
  int ri = i - g.shift, rj = j - g.shift;
  if (ri < 0) ri += g.Hp;
  if (rj < 0) rj += g.Wp;
  const int ny = ri / g.win, ty = ri - ny * g.win;
  const int nx = rj / g.win, tx = rj - nx * g.win;
  const int nwx = g.Wp / g.win;
  const int nw = (g.Hp / g.win) * nwx;
  return (b * g.win * g.win + ty * g.win + tx) * nw + ny * nwx + nx;
}

// the checks both launchers make of a geometry: rows the number of slots
// (B * Hp * Wp) or of map rows (B * H * W)
inline bool windows_valid(const Windows& g) {
  return g.win >= 1 && g.H >= 1 && g.W >= 1 && g.Hp >= g.H && g.Wp >= g.W &&
         g.Hp % g.win == 0 && g.Wp % g.win == 0 && g.shift >= 0 && g.shift < g.win;
}

}  // namespace yogo
