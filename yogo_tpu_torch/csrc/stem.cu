// Fused YOGO stem for Hopper (sm_90a): uint8 image -> pad 1 -> conv3x3
// stride 2 with inference BatchNorm folded into the weights -> LeakyReLU ->
// bf16, f32 accumulation.
//
// Replaces both TPU kernels of yogo_tpu/ops/pallas_stem.py:
//   - fused_stem      (_stem_kernel, pallas_call at :169), NHWC output:
//     here the NHWC mode, a channels_last (B, C, H/2, W/2) tensor;
//   - fused_stem_nchw (_stem_kernel_v2, pallas_call at :275), NCHW output:
//     here the NCHW mode.
// One source, the layout a template parameter.
//
// Bound: bytes. At base_model 772x1032 (C=16) one image moves 796,704 B of
// uint8 in and 6,373,632 B of bf16 out = 7,170,336 B, i.e. 458.9 MB at
// B=64, against ~57 MFLOP per image (9 FMAs x 16 channels per output
// pixel): ~8 FLOP per byte, far below the card's ridge point. The design
// therefore spends nothing on arithmetic and moves each byte once:
//   - reads: each block stages the (2*TH+1) x (2*TW+1) uint8 input window of
//     its TH x TW output tile in shared memory straight from global memory.
//     The 1-pixel zero halo is done by masking; no padded copy and no tap
//     planes exist (the TPU version built 9 shifted planes in XLA because
//     Mosaic has no strided slices). Neighbouring tiles share one input row
//     / column, which is re-read from L2, not from device memory;
//   - compute: one thread per output pixel, all C channels in registers,
//     f32 FMAs over the 9 taps (no u8->i32->f32 hop: that was a Mosaic
//     limit);
//   - writes: NCHW stores one bf16 per channel, consecutive threads on
//     consecutive columns (C coalesced row stores per warp); NHWC stores the
//     pixel's C bf16 values contiguously in 16-byte vector stores (two for
//     C=16), so a warp writes 1 KB contiguous.
//
// Tap (dy, dx), dy, dx in 0..2, reads padded[2y + dy, 2x + dx] =
// image[2y + dy - 1, 2x + dx - 1]; the weight matrix is w[c, 3*dy + dx].
//
// Built by yogo_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below, no torch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // output columns per block (one warp)
constexpr int TH = 8;   // output rows per block
constexpr int IN_W = 2 * TW + 1;
constexpr int IN_H = 2 * TH + 1;

template <int C, bool NHWC>
__global__ void __launch_bounds__(TW * TH)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int H, int W, float slope) {
  __shared__ float s_w[C * 9];
  __shared__ float s_b[C];
  __shared__ uint8_t s_in[IN_H][IN_W];

  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < C * 9; i += TW * TH) s_w[i] = w[i];
  for (int i = tid; i < C; i += TW * TH) s_b[i] = bias[i];

  const uint8_t* img = x + (size_t)b * H * W;
  for (int i = tid; i < IN_H * IN_W; i += TW * TH) {
    const int r = i / IN_W, c = i - r * IN_W;
    const int iy = iy0 + r, ix = ix0 + c;
    uint8_t v = 0;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) v = img[(size_t)iy * W + ix];
    s_in[r][c] = v;
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y, ox = ox0 + threadIdx.x;
  if (oy >= H2 || ox >= W2) return;  // ragged last tile

  float tap[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      tap[3 * dy + dx] =
          (float)s_in[2 * threadIdx.y + dy][2 * threadIdx.x + dx];

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a = s_b[c];
#pragma unroll
    for (int t = 0; t < 9; ++t) a = fmaf(s_w[c * 9 + t], tap[t], a);
    acc[c] = a >= 0.f ? a : slope * a;
  }

  if constexpr (NHWC) {
    __align__(16) __nv_bfloat162 v[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i)
      v[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    __nv_bfloat16* dst = out + (((size_t)b * H2 + oy) * W2 + ox) * C;
    if constexpr (C % 8 == 0) {
#pragma unroll
      for (int i = 0; i < C / 8; ++i)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(v)[i];
    } else {
#pragma unroll
      for (int i = 0; i < C / 4; ++i)
        reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(v)[i];
    }
  } else {
    const size_t plane = (size_t)H2 * W2;
    __nv_bfloat16* dst = out + (size_t)b * C * plane + (size_t)oy * W2 + ox;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c * plane] = __float2bfloat16_rn(acc[c]);
  }
}

template <int C>
void launch(const uint8_t* x, const float* w, const float* bias, void* out,
            int B, int H, int W, bool nhwc, float slope, cudaStream_t stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (nhwc)
    stem_kernel<C, true><<<grid, block, 0, stream>>>(x, w, bias, o, H, W, slope);
  else
    stem_kernel<C, false><<<grid, block, 0, stream>>>(x, w, bias, o, H, W, slope);
}

}  // namespace

// x: (B, H, W) uint8; w: (C, 9) f32; bias: (C,) f32; out: bf16, (B, C, H/2,
// W/2) for nhwc == 0, (B, H/2, W/2, C) for nhwc != 0. All device pointers,
// contiguous. C is one of the registry's block-0 widths (4, 8, 16, 32, 48;
// ops/stem.py STEM_CHANNELS). Returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue for arguments it does not take.
extern "C" int yogo_stem_launch(const void* x, const void* w, const void* bias,
                                void* out, int B, int H, int W, int C,
                                int nhwc, float slope, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || H % 2 || W % 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: launch<4>(xp, wp, bp, out, B, H, W, nhwc, slope, s); break;
    case 8: launch<8>(xp, wp, bp, out, B, H, W, nhwc, slope, s); break;
    case 16: launch<16>(xp, wp, bp, out, B, H, W, nhwc, slope, s); break;
    case 32: launch<32>(xp, wp, bp, out, B, H, W, nhwc, slope, s); break;
    case 48: launch<48>(xp, wp, bp, out, B, H, W, nhwc, slope, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
