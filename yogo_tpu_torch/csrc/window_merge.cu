// Swin's window merge and residual add for Hopper (sm_90a): the attention's
// projected windows (B, win*win, nW, C), bf16 or f32, back into the block's
// f32 residual map (B, H, W, C):
//   out[b, i, j, :] = x[b, i, j, :] + float(t[window_slot(b, i, j), :])
// for i < H, j < W (windows.cuh), which is
//   x + crop(roll(window_reverse(t), +shift))
// of models/yogo.py bit for bit: a bf16 -> f32 widening is exact and the add
// is one f32 round-to-nearest add, as torch's promoting add computes it.
//
// Replaces no Pallas kernel: the JAX package has no Swin trunk. It takes
// the place of the window reverse, the roll back and the crop (three copies
// of the bf16 map) and of the residual add, whose one pass over the
// attention output already read every element this kernel reads.
//
// Bound: bytes. Each map element reads 4 bytes of x and 2 (or 4) of t and
// writes 4 of out; the padded slots of t are never read. At 3.35 TB/s the
// 24 blocks of Swin-S at B=64, 772x1032, move 24.1 GB: 7.2 ms.
// Design: the LayerNorm kernel's lanes (ops/layer_norm.py plan, for an f32
// output): TPR lanes share an output row, chunk g + i * TPR of the row in
// lane g, 4 elements a chunk, so that a lane loads 16 bytes of x and 8 of
// a bf16 t and stores 16, neighbouring lanes on neighbouring bytes. A
// row's lanes map it to its window slot once; a block takes THREADS / 32
// warps' rows, the grid covers the rows.
//
// Built by yogo_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below, no torch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "windows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int MAX_C = 1536;
constexpr int MAX_CH = 16;  // chunks a lane holds at most; ops/window_merge.py MAX_CH

__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  alignas(8) __nv_bfloat162 h[2];
  *reinterpret_cast<uint2*>(h) = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// CAP: chunks a lane can hold, ch of them filled (all loads first, then
// the stores)
template <typename TT, int CAP>
__global__ void __launch_bounds__(THREADS)
window_merge_kernel(const float* __restrict__ x, const TT* __restrict__ t, float* __restrict__ out,
                    long long rows, int C, int tpr, int ch, yogo::Windows geo) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (tpr - 1);
  const int rows_per_warp = 32 / tpr;
  const long long row = (long long)blockIdx.x * (THREADS / 32) * rows_per_warp +
                        (threadIdx.x >> 5) * rows_per_warp + lane / tpr;
  if (row >= rows) return;
  const int nch = C / VEC;
  const float* xr = x + row * C;
  const TT* tr = t + yogo::window_slot(row, geo) * C;
  float* yr = out + row * C;
  float4 a[CAP], b[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int j = g + i * tpr;
    if (i < ch && j < nch) {
      a[i] = load4(xr + j * VEC);
      b[i] = load4(tr + j * VEC);
    }
  }
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int j = g + i * tpr;
    if (i < ch && j < nch)
      reinterpret_cast<float4*>(yr)[j] = make_float4(__fadd_rn(a[i].x, b[i].x), __fadd_rn(a[i].y, b[i].y),
                                                     __fadd_rn(a[i].z, b[i].z), __fadd_rn(a[i].w, b[i].w));
  }
}

template <typename TT, int CAP>
int launch(const void* x, const void* t, void* out, long long rows, int C, int tpr, int ch,
           const yogo::Windows& geo, cudaStream_t stream) {
  const long long rows_per_block = (long long)(THREADS / 32) * (32 / tpr);
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  window_merge_kernel<TT, CAP><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const TT*>(t), static_cast<float*>(out), rows, C, tpr, ch, geo);
  return (int)cudaGetLastError();
}

// the smallest build that holds ch chunks a lane: 4, 8 or MAX_CH
template <typename TT>
int launch_ch(const void* x, const void* t, void* out, long long rows, int C, int tpr, int ch,
              const yogo::Windows& geo, cudaStream_t s) {
  if (ch <= 4) return launch<TT, 4>(x, t, out, rows, C, tpr, ch, geo, s);
  if (ch <= 8) return launch<TT, 8>(x, t, out, rows, C, tpr, ch, geo, s);
  return launch<TT, MAX_CH>(x, t, out, rows, C, tpr, ch, geo, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x and out: f32 (B, H, W, C) maps, rows = B * H * W of C elements; t: the
// (B, win*win, nW, C) windows of the (Hp, Wp) map rolled by -shift, bf16 if
// t_bf16, else f32; all 16-byte aligned; C a multiple of 8 in [8, 1536];
// tpr lanes a row (a power of two up to 32) of ch <= 16 chunks of 4
// elements, tpr * ch * 4 >= C. Returns a CUDA error code (0: launched, or
// nothing to do at rows = 0).
extern "C" int yogo_window_merge_launch(const void* x, const void* t, void* out, long long rows, int C,
                                        int t_bf16, int tpr, int ch, int H, int W, int Hp, int Wp,
                                        int win, int shift, void* stream) {
  const yogo::Windows geo{H, W, Hp, Wp, win, shift};
  if (rows < 0 || C < 8 || C > MAX_C || C % 8 != 0 || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) != 0 ||
      ch < 1 || ch > MAX_CH || tpr * ch * VEC < C || !yogo::windows_valid(geo) ||
      rows % ((long long)H * W) != 0 || !aligned16(x) || !aligned16(t) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_bf16) return launch_ch<__nv_bfloat16>(x, t, out, rows, C, tpr, ch, geo, s);
  return launch_ch<float>(x, t, out, rows, C, tpr, ch, geo, s);
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
