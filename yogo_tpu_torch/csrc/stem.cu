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
// B=64: 0.137 ms at 3.35 TB/s, against 0.055 ms for its 144 FFMAs per output
// pixel at 67 TFLOP/s. Nine tenths of the bytes are the bf16 stores.
//
// What held the first version back (one thread per pixel in 32x8 tiles:
// 0.355 ms NHWC, 39% of the bound, on an H100 80GB HBM3 at 700 W) and what
// this design does about each point:
//   1. Instruction issue. Every weight was re-read from shared memory inside
//      the FMA loop and every tap converted with I2F (a quarter-rate
//      instruction): 694 SASS instructions a pixel at C=16 for 144 FFMAs.
//      Here a thread computes PX = 4 horizontally adjacent pixels (2 for
//      C >= 32), which share tap columns (27 taps for 36), converts a tap
//      with one integer add and one FADD (0x4B000000 + u8 is 2^23 + u8 as a
//      float), and reads a channel's 9 weights and bias as three broadcast
//      shared loads per PX pixels: ~310 instructions a pixel at C=16, 144 of
//      them FFMAs.
//   2. No overlap, short blocks. Each 32x8 block loaded its window with
//      1-byte loads, synchronised, computed, stored and exited (~100 waves).
//      Here the grid is persistent (blocks resident on every SM, from the
//      occupancy calculator) and each block walks bands of TH output rows x
//      the full width of one image, the TPU kernel's own tiling
//      (pallas_stem.py:236-300). A producer warp fetches the (2*TH+1) input
//      rows of a band - one contiguous byte range - with one cp.async.bulk
//      into a ring of STAGES shared buffers, signalled by an mbarrier, while
//      the consumer warps compute the band before. Consumer warps take units
//      of 32 pixel groups of successive bands with no block-wide barrier, so
//      a band's ragged last unit overlaps the next band.
//   3. Ragged tiles. W/2 = 516 left the 17th 32-wide tile 4/32 busy. Groups
//      are counted over a whole band, row after row, so only a band's last
//      unit runs part-empty (8 of 32 lanes at 772x1032: 1 unit in 33).
//   4. Stores. NCHW wrote 64 B a warp store at a row pitch that straddles
//      32-byte sectors, NHWC two 16-byte stores a thread 32 B apart. Here a
//      warp stages its unit in a shared slab and stores it back so that a
//      warp store writes 16 bytes a lane at consecutive addresses: NHWC,
//      the unit is one contiguous run (512 B a store); NCHW, each channel's
//      run of the unit (256 B at PX = 4) is whole 16-byte chunks. Shapes
//      whose units are not contiguous or aligned store pixel by pixel.
// What bounds it now (measured with yogo_tpu_torch/tools/stem_variants.py):
// variants without the stores, or with 1 of the 9 FMAs, run within a few
// per cent of it, one without the input copies some 13% faster; NCHW pays
// for sectors split at plane starts (planes start 16-byte aligned), which a
// 128-byte plane pitch would remove but the NCHW layout fixes.
// The input cannot be described by a TMA tensor map (its row stride, W
// bytes, need not be a multiple of 16), so the band is fetched as one 1-D
// bulk copy from the 16-byte boundary below its first byte to the one above
// its last: the over-fetch never leaves the 16-byte chunks that hold the
// band, so it never touches another page. The zero padding is masked in
// compute: only row -1 and column -1 fall outside the image (the last tap
// row and column of a stride-2 window are 2*(H/2)-1 = H-1 and W-1).
//
// Accumulation order is the plain version's (fused_stem_reference): bias,
// then the taps in 3*dy+dx order, in f32, LeakyReLU, one rounding to bf16.
// LeakyReLU is fmaxf(a, slope*a), equal to the select for 0 <= slope < 1.
//
// Built by yogo_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below, no torch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TH_MAX = 8;        // output rows per band (fewer if W is huge)
constexpr int STAGES = 2;        // input band buffers per block
// per channel count: PX adjacent output pixels a thread computes, and
// WARPS computing warps per block (one block an SM for C <= 16, whose
// 4-pixel threads need ~160 registers; 2-pixel threads and fewer warps for
// the wider stems keep every width free of spills)
template <int C>
struct Cfg {
  static constexpr int PX = C <= 16 ? 4 : 2;
  static constexpr int WARPS = C <= 16 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS + 32;  // + one producer warp
};

__host__ __device__ constexpr size_t stage_bytes(int th, int w) {
  // a band's rows, its start's offset in its 16-byte chunk (< 16), rounded
  // up to 16, and 16 bytes that a row's ragged last group may read past the
  // end (2*PX - 2 at most, PX <= 4)
  return ((size_t)(2 * th + 1) * w + 15 + 15) / 16 * 16 + 16;
}

// dynamic shared memory of a block: see stem_kernel
template <int C>
constexpr size_t dyn_smem(int th, int w) {
  return 16 + STAGES * stage_bytes(th, w) + (size_t)Cfg<C>::WARPS * 32 * 2 * Cfg<C>::PX * C;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One 1-D bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16-byte shared load the compiler may not hoist out of the pixel loop
// (hoisting all C*12 weights into registers would spill).
__device__ __forceinline__ float4 lds128(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

// uint8 -> exact float: 2^23 + v as bits, minus 2^23 (full-rate ops, no I2F)
__device__ __forceinline__ float u8f(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One NHWC pixel's C bf16 (C/2 packed pairs in v) to dst, 16-byte aligned
// for C % 8 == 0 and 8-byte aligned otherwise.
template <int C>
__device__ __forceinline__ void store_pixel(__nv_bfloat16* dst, const uint32_t* v) {
  if constexpr (C % 8 == 0) {
#pragma unroll
    for (int i = 0; i < C / 8; ++i)
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(v[2 * i], v[2 * i + 1]);
  }
}

// 16-byte chunk c of a warp's NHWC output slab, in which lane t owns chunks
// NCH*t .. NCH*t + NCH-1, is stored at chunk swizzle(c), so that the 8-lane
// phases of 16-byte accesses, chunks NCH*t + j for t = 8m..8m+7 (writes)
// and chunks 8m..8m+7 (reads), hit 8 distinct 16-byte bank groups, for the
// NCH = PX*C/8 of every width (2, 4, 8, 8, 12)
template <int NCH>
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c / NCH) & 7); }

// Geometry of band `band` (image, first output row, rows) and the 16-byte
// aligned global range of its input rows.
struct Band {
  int img, r0, rows, lo;  // lo: first input row held in the buffer
  const uint8_t* src;     // 16-byte aligned start of the fetch
  uint32_t shift, bytes;  // band's first byte at src + shift; fetch size
};

__device__ __forceinline__ Band band_at(const uint8_t* x, int band, int nb, int th, int H,
                                        int W) {
  Band b;
  b.img = band / nb;
  b.r0 = (band - b.img * nb) * th;
  b.rows = min(th, H / 2 - b.r0);
  b.lo = max(0, 2 * b.r0 - 1);
  const uint8_t* g = x + (size_t)b.img * H * W + (size_t)b.lo * W;
  const size_t len = (size_t)(2 * (b.r0 + b.rows) - b.lo) * W;
  b.src = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(g) & ~uintptr_t(15));
  b.shift = static_cast<uint32_t>(g - b.src);
  b.bytes = static_cast<uint32_t>((b.shift + len + 15) / 16 * 16);
  return b;
}

template <int C, bool NHWC>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B,
            int H, int W, int th, float slope) {
  // dynamic: 16 bytes, STAGES input buffers of stage_bytes(th, W), and an
  // output slab of 32 groups (2*PX*C bytes each) per consumer warp
  extern __shared__ __align__(128) uint8_t s_in[];
  uint4* s_out = reinterpret_cast<uint4*>(s_in + 16 + STAGES * stage_bytes(th, W));
  // per channel: w0..w3 | w4..w7 | w8, bias, 0, 0
  __shared__ float4 s_w[C][3];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(16) uint8_t s_zero[16];  // input row -1 (2*PX + 1 taps)

  constexpr int PX = Cfg<C>::PX, WARPS = Cfg<C>::WARPS, THREADS = Cfg<C>::THREADS;
  constexpr int CONSUMERS = 32 * WARPS;
  const int H2 = H / 2, W2 = W / 2;
  const int nb = (H2 + th - 1) / th;
  const int nbands = B * nb;
  const size_t stage = stage_bytes(th, W);
  const int tid = threadIdx.x;

  for (int c = tid; c < C; c += THREADS) {
    const float* wc = w + 9 * c;
    s_w[c][0] = make_float4(wc[0], wc[1], wc[2], wc[3]);
    s_w[c][1] = make_float4(wc[4], wc[5], wc[6], wc[7]);
    s_w[c][2] = make_float4(wc[8], bias[c], 0.f, 0.f);
  }
  if (tid < 16) s_zero[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: one lane fetches every band
    if (tid == CONSUMERS) {
      int k = 0;
      for (int band = blockIdx.x; band < nbands; band += gridDim.x, ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        const Band b = band_at(x, band, nb, th, H, W);
        bulk_load(s_in + 16 + s * stage, b.src, b.bytes, &full[s]);
      }
    }
    return;
  }

  // consumers: a band's pixels, row by row in groups of PX adjacent ones
  // (group q: output row q / ngr, columns PX*(q % ngr) ..), go in units of
  // 32 groups, one a lane; warp w takes units w, w + WARPS, ... of the
  // block's bands in turn, so a band's ragged last units overlap the next
  const int lane = tid & 31, warp = tid >> 5;
  const int ngr = (W2 + PX - 1) / PX;
  const bool whole = W2 % PX == 0;  // group q is pixels PX*q .. of the band
  // NCHW: a channel's run of a unit starts 16-byte aligned, and a band's
  // groups, rows * W2/PX, are a multiple of 8/PX (th % 4 == 0 and
  // H2 * W2 % 8 == 0), so the valid part of a run is whole 16-byte chunks
  const bool staged = NHWC ? whole : whole && (size_t)H2 * W2 % 8 == 0 && th % 4 == 0;
  const size_t plane = (size_t)H2 * W2;
  // the warp's output slab: NHWC, lane l's NCH 16-byte chunks at l*NCH..
  // (swizzled); NCHW, channel-major runs of 32 groups, lane l's PX/2 words
  // at word c*16*PX + l*PX/2
  uint4* slab = s_out + warp * (32 * PX * C / 8);
  int k = 0, band = blockIdx.x, u = warp;
  if (band >= nbands) return;
  Band b = band_at(x, band, nb, th, H, W);
  mbar_wait(&full[0], 0);
  for (;;) {
    int groups = b.rows * ngr;
    while (u * 32 >= groups) {  // this warp is done with band k
      u -= (groups + 31) / 32;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k % STAGES]);
      ++k;
      band += gridDim.x;
      if (band >= nbands) return;
      b = band_at(x, band, nb, th, H, W);
      groups = b.rows * ngr;
      mbar_wait(&full[k % STAGES], (k / STAGES) & 1);
    }
    const int q0 = 32 * u;
    u += WARPS;
    const uint8_t* base = s_in + 16 + (k % STAGES) * stage + b.shift;
    const bool valid = q0 + lane < groups;
    const int q = valid ? q0 + lane : groups - 1;  // a spare lane stores nothing
    const int r = q / ngr;
    const int y = b.r0 + r, x0 = PX * (q - r * ngr);

    // taps: input rows 2y-1..2y+1, columns 2*x0-1 .. 2*x0+2*PX-1; pixel i
    // uses columns 2i..2i+2. Row -1 reads zeros; column -1 is read (the
    // byte before the row is inside the buffer) and zeroed.
    float t[3][2 * PX + 1];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * y - 1 + dy;
      const uint8_t* p = base + (long long)(iy - b.lo) * W + 2 * x0 - 1;
      if (dy == 0 && iy < 0) p = s_zero;
#pragma unroll
      for (int j = 0; j < 2 * PX + 1; ++j) t[dy][j] = u8f(p[j]);
      if (x0 == 0) t[dy][0] = 0.f;
    }

    // v, in output memory order: NHWC pixel i's bf16 pairs of channels
    // (2m, 2m+1) at v[i*C/2 + m]; NCHW channel c's bf16 pairs of pixels
    // (2j, 2j+1) at v[c*PX/2 + j]
    uint32_t v[PX * C / 2];
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      float a[PX][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 wa = lds128(&s_w[c + h][0]), wb = lds128(&s_w[c + h][1]),
                     wc = lds128(&s_w[c + h][2]);
        const float wt[9] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w, wc.x};
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          float acc = wc.y;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc = fmaf(wt[3 * dy + dx], t[dy][2 * i + dx], acc);
          a[i][h] = fmaxf(acc, slope * acc);
        }
      }
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        if constexpr (NHWC) {
          v[i * C / 2 + c / 2] = pack_bf16(a[i][0], a[i][1]);
        } else if (i % 2 == 0) {
          v[c * PX / 2 + i / 2] = pack_bf16(a[i][0], a[i + 1][0]);
          v[(c + 1) * PX / 2 + i / 2] = pack_bf16(a[i][1], a[i + 1][1]);
        }
      }
    }

    if (staged) {
      // through the warp's slab, so that a warp store writes 16 bytes a lane
      // to consecutive addresses
      const int n = min(32, groups - q0);  // valid groups
      if constexpr (NHWC) {
        // the unit is 32 * 2*PX*C contiguous bytes
        constexpr int NCH = PX * C / 8;
#pragma unroll
        for (int j = 0; j < NCH; ++j)
          slab[swizzle<NCH>(lane * NCH + j)] = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        __syncwarp();
        uint4* dst = reinterpret_cast<uint4*>(
            out + (((size_t)b.img * H2 + b.r0) * W2 + PX * (size_t)q0) * C);
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int ch = 32 * i + lane;
          if (ch < n * NCH) dst[ch] = slab[swizzle<NCH>(ch)];
        }
      } else {
        // channel c's run is 32 * 2*PX contiguous bytes, CPC chunks
        constexpr int CPC = 4 * PX;
        uint32_t* words = reinterpret_cast<uint32_t*>(slab);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (PX == 4)
            *reinterpret_cast<uint2*>(words + c * 16 * PX + 2 * lane) = make_uint2(v[2 * c], v[2 * c + 1]);
          else
            words[c * 16 * PX + lane] = v[c];
        }
        __syncwarp();
        __nv_bfloat16* first = out + (size_t)b.img * C * plane + (size_t)b.r0 * W2 + PX * (size_t)q0;
#pragma unroll
        for (int i = 0; i < C * CPC / 32; ++i) {
          const int ch = 32 * i + lane, sub = ch % CPC;
          if (sub < n * PX / 8)
            *reinterpret_cast<uint4*>(first + (ch / CPC) * plane + 8 * sub) = slab[ch];
        }
      }
      __syncwarp();
    } else if (valid) {  // shapes whose units are not contiguous / aligned
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        if (x0 + i >= W2) break;
        if constexpr (NHWC) {
          store_pixel<C>(out + (((size_t)b.img * H2 + y) * W2 + x0 + i) * C, &v[i * C / 2]);
        } else {
          uint16_t* dst = reinterpret_cast<uint16_t*>(out) + (size_t)b.img * C * plane +
                          (size_t)y * W2 + x0 + i;
#pragma unroll
          for (int c = 0; c < C; ++c)
            dst[c * plane] = (uint16_t)(v[c * PX / 2 + i / 2] >> (16 * (i % 2)));
        }
      }
    }
  }
}

template <int C, bool NHWC>
int launch(const uint8_t* x, const float* w, const float* bias, void* out, int B, int H,
           int W, float slope, cudaStream_t stream) {
  auto kernel = stem_kernel<C, NHWC>;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return (int)cudaGetLastError();
  int th = TH_MAX;
  while (th > 1 && dyn_smem<C>(th, W) + attr.sharedSizeBytes > (size_t)optin) th /= 2;
  const size_t smem = dyn_smem<C>(th, W);
  if (smem + attr.sharedSizeBytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)attr.maxDynamicSharedSizeBytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  constexpr int THREADS = Cfg<C>::THREADS;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const long long nbands = (long long)B * ((H / 2 + th - 1) / th);
  if (nbands > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(nbands, (long long)sms * std::max(per_sm, 1));
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, static_cast<__nv_bfloat16*>(out), B, H,
                                          W, th, slope);
  return (int)cudaGetLastError();
}

template <int C>
int launch_layout(const uint8_t* x, const float* w, const float* bias, void* out, int B,
                  int H, int W, bool nhwc, float slope, cudaStream_t stream) {
  return nhwc ? launch<C, true>(x, w, bias, out, B, H, W, slope, stream)
              : launch<C, false>(x, w, bias, out, B, H, W, slope, stream);
}

}  // namespace

// x: (B, H, W) uint8; w: (C, 9) f32; bias: (C,) f32; out: bf16, (B, C, H/2,
// W/2) for nhwc == 0, (B, H/2, W/2, C) for nhwc != 0, 16-byte aligned. All
// device pointers, contiguous; x may start at any byte. C is one of the
// registry's block-0 widths (4, 8, 16, 32, 48; ops/stem.py STEM_CHANNELS).
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int yogo_stem_launch(const void* x, const void* w, const void* bias,
                                void* out, int B, int H, int W, int C,
                                int nhwc, float slope, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || H % 2 || W % 2 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: return launch_layout<4>(xp, wp, bp, out, B, H, W, nhwc, slope, s);
    case 8: return launch_layout<8>(xp, wp, bp, out, B, H, W, nhwc, slope, s);
    case 16: return launch_layout<16>(xp, wp, bp, out, B, H, W, nhwc, slope, s);
    case 32: return launch_layout<32>(xp, wp, bp, out, B, H, W, nhwc, slope, s);
    case 48: return launch_layout<48>(xp, wp, bp, out, B, H, W, nhwc, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
