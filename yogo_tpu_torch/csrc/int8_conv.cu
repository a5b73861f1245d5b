// int8 convolution for Hopper (sm_90a): s8 x s8 -> s32 implicit GEMM on the
// tensor cores, with the int8 program's f32 epilogue fused.
//
// Replaces the XLA int8 conv of the JAX package's quantized forward
// (yogo_tpu/ops/quant.py:612, `_conv(q, w8, spec, jnp.int32)`, with the
// dequant + bias + activation of :613-614 and the requant of the next
// quantized block, :609-611). There is no Pallas kernel behind it: torch has
// no int8 convolution on CUDA, so the port needs this one.
//
// For one block, with M = B*Ho*Wo output pixels, N = Cout, K = kh*kw*Cp:
//   acc[m, n] = sum_k A[m, k] * W[n, k]               (int32, exact)
//   h         = act(float(acc) * deq[n] + bias[n])    (f32, two roundings)
//   out       = h (f32 NHWC, Cout channels)
//            or clip(rint(h / s_next), -127, 127)    (int8 NHWC, Cop channels)
// A is never materialised: row m of A is the kh x kw window of input pixels
// of output pixel m, each Cp channels deep (implicit GEMM). Activations are
// int8 NHWC with Cp, a multiple of 32, channels (zero codes in the padding);
// weights are packed at quantize time as [Cout][kh][kw][Cp], so W's rows are
// K-major. Zero padding of the image is zero codes, rint(0 / s).
//
// Bound: at base_model's quantized blocks (B=64, 772x1032: M = 800,832,
// N = 128, K = 1,152) a block is 236 G int8 operations, 0.119 ms at the
// H100's 1,979 dense int8 TOPS. Block 5 (int8 in, int8 out: 205 MB, 0.061
// ms at 3.35 TB/s) is bound by the operations; block 4 (its stride-2 input
// is 4x its output: 510 MB) and block 6 (f32 out: 512 MB) by the bytes,
// ~0.15 ms each.
//
// Design (a first, simple version: mma.sync, not wgmma / TMA):
//   - Tiles of BM = 128 pixels x BN = 128 channels a block, BK = 128 bytes of
//     K a stage; 8 warps, each 32 x 64 of the tile: 2 x 8 m16n8k32 products
//     a k-step of 32 bytes (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32).
//   - Each thread loads 4 16-byte chunks of A and 4 of W a stage with
//     cp.async (zero-filled outside the image, past M, N or K) into a ring
//     of STAGES shared buffers, so the loads of stage k+2 overlap the
//     products of stage k. Since Cp is a multiple of 32, each 32-byte pair
//     of chunks lies in one tap: one tap computation per pair.
//   - Shared rows are 128 bytes; chunk c of row r lives at chunk c ^ (r & 7),
//     so ldmatrix's eight 16-byte rows hit eight distinct bank groups.
//     ldmatrix.x4 loads an m16 x k32 A fragment or two n8 x k32 B fragments.
//   - The epilogue dequantizes in registers (__fmul_rn / __fadd_rn, so no
//     FMA contraction: the plain version and the JAX program round twice),
//     applies the activation, requantizes (__fdiv_rn, rintf: half to even,
//     as jnp.round), stages the tile in shared memory and writes it back in
//     16-byte stores of whole rows of the tile.
// Later work: wgmma with TMA-fed operands and warp specialisation; fusing
// the entry requant into block 3's epilogue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;  // bytes of K a stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * BK;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 96 KiB
constexpr int F32_PITCH = BN + 4;                 // floats a staged output row
constexpr int S8_PITCH = BN + 16;                 // bytes a staged output row
static_assert(BM * F32_PITCH * 4 <= SMEM_BYTES, "f32 staging must fit the ring");

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_SILU = 2 };

struct Params {
  const int8_t* x;          // (B, H, W, Cp)
  const int8_t* w;          // (Cout, kh, kw, Cp)
  const float* deq;         // (Cout,)
  const float* bias;        // (Cout,)
  const float* out_scale;   // one float, int8 output only
  void* out;                // (B, Ho, Wo, Cout) f32 or (B, Ho, Wo, Cop) int8
  int B, H, W, Cp, Cout, Cop, kh, kw, stride, pad, Ho, Wo, M, K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of 16-byte chunk c of tile row r in a stage buffer
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ (r & 7)) << 4); }

// the activations as torch computes them on the card
template <int ACT>
__device__ __forceinline__ float activate(float h) {
  if (ACT == ACT_LEAKY) return h > 0.f ? h : __fmul_rn(h, 0.01f);
  if (ACT == ACT_SILU) return __fdiv_rn(h, __fadd_rn(1.f, expf(-h)));
  return h;
}

template <int ACT>
__device__ __forceinline__ float epilogue(int acc, float deq, float bias) {
  return activate<ACT>(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias));
}

__device__ __forceinline__ int8_t requant(float h, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(h, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <int ACT, bool OUT_S8>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's loads: tile row lr, chunks lc0 .. lc0+3, of A and of W
  const int lr = tid >> 1, lc0 = (tid & 1) * 4;
  const int m = m0 + lr;
  const bool m_ok = m < p.M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xb = p.x;
  if (m_ok) {
    const int hw = p.Ho * p.Wo;
    const int b = m / hw, r = m - b * hw;
    const int oy = r / p.Wo, ox = r - oy * p.Wo;
    iy0 = oy * p.stride - p.pad;
    ix0 = ox * p.stride - p.pad;
    xb = p.x + (long long)b * p.H * p.W * p.Cp;
  }
  const int n = n0 + lr;
  const bool n_ok = n < p.Cout;
  const int8_t* wrow = p.w + (long long)(n_ok ? n : 0) * p.K;
  const int KT = (p.K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    uint8_t* a_s = smem + stage * STAGE_BYTES;
    uint8_t* b_s = a_s + BM * BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two 32-byte pairs, each inside one tap
      const int c = lc0 + 2 * h;
      const int k = kt * BK + c * 16;
      const bool k_ok = k < p.K;  // K is a multiple of 32: a pair is in or out
      const int tap = k / p.Cp, ci = k - tap * p.Cp;
      const int dy = tap / p.kw, dx = tap - dy * p.kw;
      const int iy = iy0 + dy, ix = ix0 + dx;
      const bool a_ok = m_ok && k_ok && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const bool b_ok = n_ok && k_ok;
      const int8_t* asrc = a_ok ? xb + ((long long)iy * p.W + ix) * p.Cp + ci : p.x;
      const int8_t* bsrc = b_ok ? wrow + k : p.w;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cp_async16(smem_u32(a_s + swz(lr, c + e)), a_ok ? asrc + 16 * e : asrc, a_ok);
        cp_async16(smem_u32(b_s + swz(lr, c + e)), b_ok ? bsrc + 16 * e : bsrc, b_ok);
      }
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();
    const uint8_t* a_s = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* b_s = a_s + BM * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // matrices: rows 0-7 / 8-15 of bytes 0-15, then of bytes 16-31
        const int r = wm * 32 + mt * 16 + (lane & 15);
        const int c = 2 * ks + (lane >> 4);
        ldmatrix_x4(smem_u32(a_s + swz(r, c)), a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices: n8 tile 2np at bytes 0-15 / 16-31, then tile 2np+1
        const int r = wn * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = 2 * ks + ((lane >> 3) & 1);
        ldmatrix_x4(smem_u32(b_s + swz(r, c)), b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                    b[2 * np + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  const int g = lane >> 2, tg = lane & 3;
  if (OUT_S8) {
    const float s_next = __ldg(p.out_scale);
    int8_t* st = reinterpret_cast<int8_t*>(smem);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = wn * 64 + nt * 8 + tg * 2;
      const int na = n0 + col, nb = na + 1;
      const bool oka = na < p.Cout, okb = nb < p.Cout;
      const float da = oka ? __ldg(p.deq + na) : 0.f, ba = oka ? __ldg(p.bias + na) : 0.f;
      const float db = okb ? __ldg(p.deq + nb) : 0.f, bb = okb ? __ldg(p.bias + nb) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = wm * 32 + mt * 16 + g + hf * 8;
          char2 v;
          v.x = oka ? requant(epilogue<ACT>(acc[mt][nt][2 * hf], da, ba), s_next) : 0;
          v.y = okb ? requant(epilogue<ACT>(acc[mt][nt][2 * hf + 1], db, bb), s_next) : 0;
          *reinterpret_cast<char2*>(st + row * S8_PITCH + col) = v;
        }
    }
    __syncthreads();
    // Cop is a multiple of 32: whole 16-byte chunks, 16-byte aligned rows
    const int ncols = min(BN, p.Cop - n0), cpr = ncols / 16;
    int8_t* out = static_cast<int8_t*>(p.out);
    for (int i = tid; i < BM * cpr; i += THREADS) {
      const int row = i / cpr, ch = i - row * cpr, mm = m0 + row;
      if (mm < p.M)
        *reinterpret_cast<int4*>(out + (long long)mm * p.Cop + n0 + ch * 16) =
            *reinterpret_cast<const int4*>(st + row * S8_PITCH + ch * 16);
    }
  } else {
    float* st = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = wn * 64 + nt * 8 + tg * 2;
      const int na = n0 + col, nb = na + 1;
      const bool oka = na < p.Cout, okb = nb < p.Cout;
      const float da = oka ? __ldg(p.deq + na) : 0.f, ba = oka ? __ldg(p.bias + na) : 0.f;
      const float db = okb ? __ldg(p.deq + nb) : 0.f, bb = okb ? __ldg(p.bias + nb) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = wm * 32 + mt * 16 + g + hf * 8;
          float2 v;
          v.x = epilogue<ACT>(acc[mt][nt][2 * hf], da, ba);
          v.y = epilogue<ACT>(acc[mt][nt][2 * hf + 1], db, bb);
          *reinterpret_cast<float2*>(st + row * F32_PITCH + col) = v;
        }
    }
    __syncthreads();
    const int ncols = min(BN, p.Cout - n0);
    float* out = static_cast<float*>(p.out);
    if (p.Cout % 4 == 0) {  // 16-byte aligned rows: 16-byte stores
      const int cpr = ncols / 4;
      for (int i = tid; i < BM * cpr; i += THREADS) {
        const int row = i / cpr, ch = i - row * cpr, mm = m0 + row;
        if (mm < p.M)
          *reinterpret_cast<float4*>(out + (long long)mm * p.Cout + n0 + ch * 4) =
              *reinterpret_cast<const float4*>(st + row * F32_PITCH + ch * 4);
      }
    } else {
      for (int i = tid; i < BM * ncols; i += THREADS) {
        const int row = i / ncols, col = i - row * ncols, mm = m0 + row;
        if (mm < p.M) out[(long long)mm * p.Cout + n0 + col] = st[row * F32_PITCH + col];
      }
    }
  }
}

template <int ACT, bool OUT_S8>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<ACT, OUT_S8>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.M + BM - 1) / BM, (p.Cop + BN - 1) / BN);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_out(const Params& p, bool out_s8, cudaStream_t stream) {
  return out_s8 ? launch<ACT, true>(p, stream) : launch<ACT, false>(p, stream);
}

}  // namespace

// x: (B, H, W, Cp) int8 codes, Cp a multiple of 32; w: (Cout, k, k, Cp) int8;
// deq, bias: (Cout,) f32; out_scale: one f32 (read when out_s8 != 0, may be
// null otherwise); out: f32 (B, Ho, Wo, Cout) for out_s8 == 0, int8
// (B, Ho, Wo, Cop) with Cop = Cout rounded up to 32 otherwise. x, w and out
// 16-byte aligned; all device pointers, contiguous. act: 0 identity, 1
// LeakyReLU 0.01, 2 SiLU. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for arguments it does not take.
extern "C" int yogo_int8_conv_launch(const void* x, const void* w, const void* deq,
                                     const void* bias, const void* out_scale, void* out, int B,
                                     int H, int W, int Cp, int Cout, int k, int stride, int pad,
                                     int act, int out_s8, void* stream) {
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (B <= 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 32 || Cout <= 0 || k <= 0 || stride <= 0 ||
      pad < 0 || act < 0 || act > 2 || (out_s8 && !out_scale) || misaligned(x) ||
      misaligned(w) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.deq = static_cast<const float*>(deq);
  p.bias = static_cast<const float*>(bias);
  p.out_scale = static_cast<const float*>(out_scale);
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.Cp = Cp, p.Cout = Cout, p.Cop = (Cout + 31) / 32 * 32;
  p.kh = k, p.kw = k, p.stride = stride, p.pad = pad;
  p.Ho = (H + 2 * pad - k) / stride + 1;
  p.Wo = (W + 2 * pad - k) / stride + 1;
  const long long M = (long long)B * p.Ho * p.Wo;
  const long long K = (long long)k * k * Cp;
  if (p.Ho <= 0 || p.Wo <= 0 || M > 0x7fffffffLL || K > 0x7fffffffLL ||
      (long long)B * H * W * Cp > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  p.M = (int)M;
  p.K = (int)K;
  auto s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ACT_LEAKY: return launch_out<ACT_LEAKY>(p, out_s8, s);
    case ACT_SILU: return launch_out<ACT_SILU>(p, out_s8, s);
    default: return launch_out<ACT_NONE>(p, out_s8, s);
  }
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
