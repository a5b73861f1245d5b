// LayerNorm over the last axis for Hopper (sm_90a): rows of C contiguous
// elements (bf16 or f32) -> f32 statistics -> the output in the dtype its
// consumer reads (bf16 or f32), one pass over the row.
//
// Replaces no Pallas kernel: the JAX package leaves flax's nn.LayerNorm to
// XLA, which fuses it into one pass. The port's plain version,
// models/yogo.layer_norm, is a chain of whole-tensor torch ops (cast, mean,
// square, mean, subtract, scale, add, then the consumer's cast): some eight
// passes over the activation, 46-52 bytes of traffic an element, in the
// ConvNeXt and Swin trunks' 40 and 53 LayerNorms a forward.
//
// Arithmetic: exactly the plain version's, in f32 round-to-nearest with no
// FMA contraction (__fmul_rn / __fadd_rn), so only the order of summation
// differs (a thread's chunks in order, then a butterfly over the row's lanes,
// which leaves every lane with the same sums):
//   mean = sum(x) / C,  var = max(0, sum(x*x) / C - mean*mean)  (NaN kept),
//   y    = (x - mean) * (rsqrt(var + eps) * w) + b,
// rounded once to the output dtype; rsqrtf is the instruction torch's rsqrt
// runs on the card.
//
// Bound: bytes. Each input element is read once and each output element
// written once: 2 or 4 bytes in plus 2 or 4 out (4-8 B an element; w and b,
// 8C bytes, stay in L1 and L2). At 3.35 TB/s the trunks' B=64
// LayerNorms move 19.1 GB (ConvNeXt-Small) and 34.3 GB (Swin-S) a forward.
// A windowed store (design 4) reads the map's rows and writes the padded
// map's: 4 bytes an element of the one, 2 or 4 of the other.
// Design:
//   1. A row is split into chunks of VEC elements: 8 for a bf16 output, so
//      that a lane stores 16 bytes (and loads 16 of bf16, 32 of f32); 4 for
//      an f32 output, so that a lane stores 16 bytes and neighbouring lanes
//      neighbouring bytes (an 8-element f32 chunk would store 32 bytes a
//      lane in two 16-byte halves, each warp store then half-filling its
//      sectors: 60% of the bound, against 86% for f32 -> bf16, on an H100).
//      TPR lanes (a power of two up to 32) share a row, each holding CH
//      chunks in registers; the caller's plan (ops/layer_norm.py plan) picks
//      TPR and CH from C and VEC alone so that no lane idles at the trunks'
//      widths: a bf16 output at C = 96 / 192 / 384 / 768 -> 4 / 8 / 16 / 32
//      lanes of 3 chunks (8 / 4 / 2 / 1 rows a warp), 1,536 -> 32 lanes of
//      6; an f32 output at 96 -> 8 lanes of 3. Chunk i of lane g is chunk
//      g + i * TPR of the row, so neighbouring lanes read neighbouring
//      bytes. The kernel holds CAP chunks a lane, CH of them filled: three
//      builds a dtype pair, of 16, 32 and 64 elements a lane, so that the
//      library builds in seconds and a short row does not pay a long row's
//      registers (a lane of 32 elements holding the f32-output stem's 12
//      ran 17% slower than one of 12, tools/layer_norm_variants.py).
//   2. The sums come from the registers in the same pass and are reduced by
//      shuffles; the row is normalised from the registers and stored with
//      16-byte stores. Nothing touches device memory twice.
//   3. A block takes THREADS / 32 warps' rows once, and the grid covers the
//      rows (a persistent grid that walked them was 7-9% slower at the
//      trunks' shapes, tools/layer_norm_variants.py). A lane reads its w and
//      b (8C bytes a row's lanes share) through L1: staging them in shared
//      memory once a block measured 0-6% slower.
//   4. Windowed store (WIN, the launch given a window geometry): the norm
//      before Swin's window attention writes its output straight into the
//      shifted, padded windows that attention reads (windows.cuh). Output
//      row r is window slot r; it normalises the map row window_source(r)
//      names, with the same arithmetic, or stores zeros where the slot lies
//      in the padding (Swin pads after the norm: a pad token is 0, not
//      LN(0)). So the pad, the roll and the partition need no copies of
//      the map (2-3 passes over a bf16 map each). Only an f32 input (the
//      residual stream) takes it, and the plain row store keeps its
//      machine code (the geometry is the kernel's last parameter, unread
//      there).
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
constexpr int MAX_C = 1536;
constexpr int MAX_ELEMS = 64;  // elements a lane holds; ops/layer_norm.py MAX_ELEMS

// A chunk of VEC (4 or 8) elements: loaded into / stored from f32 registers
// with 8- or 16-byte accesses, each four elements of f32 one float4.
template <int VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* v) {
  alignas(16) __nv_bfloat162 h[VEC / 2];
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(h) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    *reinterpret_cast<uint2*>(h) = __ldg(reinterpret_cast<const uint2*>(p));
  }
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void load_chunk(const float* p, float* v) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  alignas(16) __nv_bfloat162 h[VEC / 2];
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  } else {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k)
    reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// CAP: chunks a lane can hold; chunk g + i * tpr exists for i < ch <= CAP
// only (tpr * ch * VEC >= C), so the j < nch test leaves the rest empty.
// WIN: row is a window slot of geo (design 4); else row is the input's row
template <typename TIn, typename TOut, int VEC, int CAP, bool WIN>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, TOut* __restrict__ y, long long rows,
                  int C, int tpr, float eps, yogo::Windows geo) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (tpr - 1);  // the lane's place in its row
  const int rows_per_warp = 32 / tpr;
  const long long row = (long long)blockIdx.x * (THREADS / 32) * rows_per_warp +
                        (threadIdx.x >> 5) * rows_per_warp + lane / tpr;
  const bool live = row < rows;
  const int nch = C / VEC;
  const float fc = (float)C;

  long long src = row;  // the input row; -1: a padded slot
  if constexpr (WIN) src = live ? yogo::window_source(row, geo) : -1;
  const bool read = WIN ? src >= 0 : live;
  const TIn* xr = x + (WIN ? (read ? src : 0) : row) * C;
  float v[CAP][VEC];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int j = g + i * tpr;
    if (read && j < nch) {
      load_chunk<VEC>(xr + j * VEC, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[i][k] = 0.f;
    }
  }
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s = __fadd_rn(s, v[i][k]);
      q = __fadd_rn(q, __fmul_rn(v[i][k], v[i][k]));
    }
  }
  // the whole warp shuffles (rows past the end hold zeros); lanes of a row
  // are an aligned group of tpr, so xor by less than tpr stays in it
  for (int off = tpr >> 1; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, off));
  }
  if (!live) return;
  if constexpr (WIN) {
    if (src < 0) {
      float zero[VEC] = {};
      for (int j = g; j < nch; j += tpr) store_chunk<VEC>(y + row * C + j * VEC, zero);
      return;
    }
  }
  const float mean = __fdiv_rn(s, fc);
  float var = __fsub_rn(__fdiv_rn(q, fc), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // clamp_min: a NaN stays NaN
  const float r = rsqrtf(__fadd_rn(var, eps));
  TOut* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int j = g + i * tpr;
    if (j < nch) {
      float wk[VEC], bk[VEC], o[VEC];
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k) {
        const float4 wa = __ldg(reinterpret_cast<const float4*>(w + j * VEC) + k);
        const float4 ba = __ldg(reinterpret_cast<const float4*>(b + j * VEC) + k);
        wk[4 * k] = wa.x; wk[4 * k + 1] = wa.y; wk[4 * k + 2] = wa.z; wk[4 * k + 3] = wa.w;
        bk[4 * k] = ba.x; bk[4 * k + 1] = ba.y; bk[4 * k + 2] = ba.z; bk[4 * k + 3] = ba.w;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[i][k], mean), __fmul_rn(r, wk[k])), bk[k]);
      store_chunk<VEC>(yr + j * VEC, o);
    }
  }
}

template <typename TIn, typename TOut, int VEC, int CAP, bool WIN>
int launch(const void* x, const void* w, const void* b, void* y, long long rows, int C,
           int tpr, float eps, const yogo::Windows& geo, cudaStream_t stream) {
  const long long rows_per_block = (long long)(THREADS / 32) * (32 / tpr);
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  layer_norm_kernel<TIn, TOut, VEC, CAP, WIN><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<TOut*>(y), rows, C, tpr, eps, geo);
  return (int)cudaGetLastError();
}

// the smallest build that holds ch chunks a lane: 16, 32 or 64 elements
template <typename TIn, typename TOut, int VEC, bool WIN = false>
int launch_ch(int ch, const void* x, const void* w, const void* b, void* y, long long rows,
              int C, int tpr, float eps, const yogo::Windows& g, cudaStream_t s) {
  if (ch * VEC <= 16) return launch<TIn, TOut, VEC, 16 / VEC, WIN>(x, w, b, y, rows, C, tpr, eps, g, s);
  if (ch * VEC <= 32) return launch<TIn, TOut, VEC, 32 / VEC, WIN>(x, w, b, y, rows, C, tpr, eps, g, s);
  return launch<TIn, TOut, VEC, MAX_ELEMS / VEC, WIN>(x, w, b, y, rows, C, tpr, eps, g, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: rows x C (bf16 if in_bf16, else f32), w and b: C f32, y: rows x C (bf16
// if out_bf16, else f32), all 16-byte aligned; C a multiple of 8 in
// [8, 1536]; tpr lanes a row (a power of two up to 32) holding ch chunks of
// VEC elements each (VEC 8 for a bf16 output, 4 for f32; ch * VEC <= 64),
// tpr * ch * VEC >= C.
// win > 0: the windowed store (design 4): x is an f32 (B, H, W, C) map and y
// its (B, win*win, nW, C) windows of the map padded to (Hp, Wp) and rolled
// by -shift; rows counts y's rows, B * Hp * Wp. win = 0: the other four
// ints are unread. Returns a CUDA error code (0: launched, or nothing to do
// at rows = 0).
extern "C" int yogo_layer_norm_launch(const void* x, const void* w, const void* b, void* y,
                                      long long rows, int C, int in_bf16, int out_bf16,
                                      int tpr, int ch, float eps, int H, int W, int Hp, int Wp,
                                      int win, int shift, void* stream) {
  const int vec = out_bf16 ? 8 : 4;
  if (rows < 0 || C < 8 || C > MAX_C || C % 8 != 0 || tpr < 1 || tpr > 32 ||
      (tpr & (tpr - 1)) != 0 || ch < 1 || ch * vec > MAX_ELEMS || tpr * ch * vec < C ||
      !aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const yogo::Windows geo{H, W, Hp, Wp, win, shift};
  if (win != 0 && (in_bf16 || !yogo::windows_valid(geo) || rows % ((long long)Hp * Wp) != 0))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win != 0) {
    if (out_bf16) return launch_ch<float, __nv_bfloat16, 8, true>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
    return launch_ch<float, float, 4, true>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
  }
  if (in_bf16 && out_bf16)
    return launch_ch<__nv_bfloat16, __nv_bfloat16, 8>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
  if (in_bf16) return launch_ch<__nv_bfloat16, float, 4>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
  if (out_bf16) return launch_ch<float, __nv_bfloat16, 8>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
  return launch_ch<float, float, 4>(ch, x, w, b, y, rows, C, tpr, eps, geo, s);
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
