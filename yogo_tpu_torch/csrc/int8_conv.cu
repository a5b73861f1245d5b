// int8 convolution for Hopper (sm_90a): s8 x s8 -> s32 implicit GEMM on the
// tensor cores through wgmma, its operands fed by TMA, with the int8
// program's f32 epilogue fused.
//
// Replaces the XLA int8 conv of the JAX package's quantized forward
// (yogo_tpu/ops/quant.py:612, `_conv(q, w8, spec, jnp.int32)`, with the
// dequant + bias + activation of :613-614 and the requant of the next
// quantized block, :609-611) and the s8 dots / convs of its ConvNeXt program
// (yogo_tpu/ops/quant_convnext.py:416-439). There is no Pallas kernel behind
// it: torch has no int8 convolution on CUDA, so the port needs this one.
//
// For one block or site, with M = B*Ho*Wo output pixels, N = Cout, K = kh*kw*Cp:
//   acc[m, n] = sum_k A[m, k] * W[n, k]               (int32, exact)
//   h         = act(float(acc) * deq[n] + bias[n])    (f32, two roundings)
//   out       = h (f32 NHWC, Cout channels)
//            or clip(rint(h / s_next), -127, 127)    (int8 NHWC, Cop channels)
// A is never materialised: row m of A is the kh x kw window of input pixels
// of output pixel m, each Cp channels deep (implicit GEMM). Activations are
// int8 NHWC with Cp, a multiple of 32, channels (zero codes in the padding);
// weights are packed at quantize time as [Cout][kh][kw][Cp], so W's rows are
// K-major, as are A's: wgmma's integer form takes both operands K-major.
//
// Bound (B=64, 772x1032, H100 SXM: 3.35 TB/s, 1,979 dense int8 TOPS):
//   base_model blocks 4 / 5 / 6 (M 800,832, N 128, K 1,152; 236 G ops):
//     0.152 ms (bytes: the stride-2 input) / 0.119 (operations) / 0.153
//     (bytes: the f32 output);
//   ConvNeXt-Small stage2 pwconv1 (1x1, 384 -> 1,536, M 196,608) 0.383,
//     pwconv2 (1,536 -> 384) 0.180, down2_conv (2x2 s2, 192 -> 384) 0.136:
//     bytes, the f32 outputs above all.
//
// Design (each launch's plan is computed by ops/int8_conv.py launch_plan;
// plan_ok below takes only the plan it computes for the shape and the card):
//   - Warp specialisation, persistent: one block an SM of consumer
//     warpgroups and one producer warp, one thread of which issues every TMA
//     load: three consumers at N tiles of 128 (416 threads, 128 registers a
//     thread), two at 256 or for SiLU (288 threads, 224). (A producer
//     warpgroup handing its registers to the consumers with setmaxnreg, 384
//     threads, did not help: ptxas still held the consumers to the block's
//     168 registers, and their epilogue spilled.)
//   - Each block keeps one N tile (block b: N tile b % n_tiles) and walks M
//     tiles b / n_tiles, + grid / n_tiles, ...: the blocks that run at one
//     time cover every N tile of the same rows of codes, which L2 then
//     serves to all of them. Its consumers take the tiles in turn: one runs
//     its mainloop while the others run their epilogues (the int8 requant
//     makes an epilogue longer than a mainloop at base_model's blocks). The
//     mainloops take turns through an mbarrier a consumer, so no consumer
//     waits on a ring slot a phase ahead.
//   - A consumer's tile is 64 x 128 (one m64n128k32 product a 32-byte
//     k-step; 64 s32 accumulators a thread) or, for an f32 output, 64 x 256
//     (m64n256k32, 128 accumulators).
//   - Operands: each stage is 128 bytes of K of A (the tile's rows) and, unless
//     resident, of W (the tile's N rows), 128B-swizzled by TMA; the wgmma
//     descriptors (K-major, 128B swizzle, 1,024 bytes between 8-row groups)
//     advance 32 bytes a k-step within the swizzle row. A for 1x1 is a tiled
//     TMA load of the [M, Cp] code matrix; for 3x3 s1 / s2 and 2x2 s2 it is
//     TMA's im2col mode over the 4-D NHWC codes: the pixel box corners are
//     -pad and pad - (k - 1), the traversal stride is the conv stride, and
//     each copy names its tap (dx, dy): TMA does the tap arithmetic and the
//     zero fill at the image edges and past the last image. W is a tiled
//     load of [Cout, taps, Cp]. A K tail (Cp not a multiple of 128) is the
//     zero fill past Cp. The K loop walks taps outside and 128-channel chunks
//     inside; one thread issues the loads, no thread computes an address.
//   - Where a block's whole [block_n, K] weight tile fits beside a ring of
//     at least 4 A stages (base_model: 147 KB of 227, and a 6-deep ring;
//     ConvNeXt's pwconv1 96 KB, down2_conv 128 KB), it is loaded once a
//     block and stays; the ring then carries A alone. Otherwise (pwconv2:
//     192 KB) the ring carries A and W.
//   - Epilogue: the plain version's arithmetic, on wgmma's accumulator
//     fragment: the dequant with __fmul_rn / __fadd_rn (no FMA contraction:
//     the plain version and the JAX program round twice), the activation,
//     the requant as a correctly rounded division (an IEEE reciprocal and
//     two FMA corrections, no branch: div_by_scale) and a round-half-to-even
//     conversion (as jnp.round), zero codes in the padded channels. deq and
//     bias of the block's N tile wait in shared memory. Sub-tiles of 64 rows
//     x 128 bytes are written to 128B-swizzled shared buffers (no bank
//     conflicts) and stored by TMA, which clips the ragged M and N edges;
//     the stores overlap the next tiles. An f32 output whose rows are not
//     16-byte multiples (Cout % 4) is stored from the registers, one float
//     at a time.
// What bounds it (tools/int8_conv_variants.py, PERF.md section 6): at the
// 3x3 blocks the consumers' own work, not the A feed: their mainloops,
// taking turns, with the epilogue's staging take 0.205 of block 5's 0.308
// ms; the epilogue arithmetic and stores add 0.08, the loads 0.07, both
// 0.10 (with no loads at all block 5 takes 0.288). Mainloops that overlap
// through a ring a consumer (2 slots each beside the resident weights)
// take twice as long: the loads' latency shows. At pwconv1 and down2_conv
// the output stores bound it; at pwconv2 the streamed weights and codes.
// Later work (ROADMAP): split what holds the 3x3 blocks (one warpgroup's
// wgmma issue rate, the epilogue's and the loads' collisions with the
// mainloop); fuse the entry requant into block 3's epilogue.

#include <cuda.h>  // CUtensorMap and the driver's types; the entry points come from cudart
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_SILU = 2 };

// consumer warpgroups a block: three of 64 accumulators a thread at N tiles
// of 128 (416 threads, 128 registers a thread), else two (288 threads, 224
// registers: 128 accumulators, or SiLU's division, whose slow path is a call)
__host__ __device__ constexpr int consumers(int bn, int act) {
  return bn == 128 && act != ACT_SILU ? 3 : 2;
}
// and the producer warp
__host__ __device__ constexpr int threads(int bn, int act) { return 128 * consumers(bn, act) + 32; }
constexpr int K_BLOCK = 128;  // bytes of K a stage
constexpr int BM = 64;        // rows of a consumer's tile: one m64 product
constexpr int SUB_BYTES = BM * 128;  // an epilogue sub-tile: 64 rows of 128 bytes
constexpr int SMEM_LIMIT = 232448;
constexpr int SMEM_ALIGN = 1024;
constexpr int BARRIER_BYTES = 256;
constexpr int MAX_STAGES = 8;
constexpr int MIN_RESIDENT_STAGES = 4;  // keep the weights resident only with this deep an A ring
// k-blocks of products a consumer leaves running when it issues the next
// (2 was no faster at any site, and slower at down2_conv: int8_conv_variants)
constexpr int IN_FLIGHT = 1;
constexpr int MAX_TAPS = 9;
// a wait this long means the pipeline is broken: trap rather than hang
constexpr long long WAIT_LIMIT_CYCLES = 20000000000LL;
// launcher error codes past cudaError's
constexpr int ERR_DRIVER_ENTRY = 10000;  // cuTensorMapEncode* not found
constexpr int ERR_ENCODE = 20000;        // + the CUresult of a failed encode

enum Route { ROUTE_TILED = 0, ROUTE_IM2COL = 1 };
enum Store { STORE_TMA = 0, STORE_DIRECT = 1 };

// ops/int8_conv.py LaunchPlan, in its field order
struct Plan {
  int block_m, block_n, route, chunks, taps, k_blocks, m_tiles, n_tiles, tiles, grid, stages,
      resident_b, store, epi_bufs, smem_bytes, a_stage_bytes, b_chunk_bytes, ring_stage_bytes,
      b_offset, ring_offset, epi_offset, vec_offset, bar_offset, box_lower, box_upper,
      traversal_stride, consumers;
  int tap_dx[MAX_TAPS], tap_dy[MAX_TAPS];
};
constexpr int PLAN_LEN = sizeof(Plan) / sizeof(int);
static_assert(PLAN_LEN == 27 + 2 * MAX_TAPS, "Plan must match LaunchPlan.to_array");

struct Params {
  const float* deq;        // (Cout,)
  const float* bias;       // (Cout,)
  const float* out_scale;  // one float, int8 output only
  void* out;               // (B, Ho, Wo, Cout) f32 or (B, Ho, Wo, Cop) int8
  int M, Cout, Ho, Wo;
  Plan plan;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
}

// ---- TMA
__device__ __forceinline__ uint64_t map_addr(const CUtensorMap* map) {
  return reinterpret_cast<uint64_t>(map);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map_addr(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map_addr(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// pixels from (w, h, n) on through the map's bounding box, each read at
// (w + off_w, h + off_h), channels c .. c + channelsPerPixel - 1
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int c, int w, int h, int n,
                                                uint16_t off_w, uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(map_addr(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   map_addr(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma
// K-major operand in shared memory, 128B swizzle: rows of 128 bytes, 8-row
// groups 1,024 bytes apart (stride byte offset 64 x 16 bytes); the leading
// byte offset is unused for a swizzled K-major operand (1 by convention)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

#define OPS8(a, i)                                                                             \
  "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3]), "+r"(a[i + 4]), "+r"(a[i + 5]), \
      "+r"(a[i + 6]), "+r"(a[i + 7])

// d (64 x N, s32, wgmma's accumulator fragment) = A (64 x 32 bytes) * B^T
// (N x 32 bytes) + (scale_d ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma<128>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : OPS8(d, 0), OPS8(d, 8), OPS8(d, 16), OPS8(d, 24),
        OPS8(d, 32), OPS8(d, 40), OPS8(d, 48), OPS8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : OPS8(d, 0), OPS8(d, 8), OPS8(d, 16), OPS8(d, 24),
        OPS8(d, 32), OPS8(d, 40), OPS8(d, 48), OPS8(d, 56),
        OPS8(d, 64), OPS8(d, 72), OPS8(d, 80), OPS8(d, 88),
        OPS8(d, 96), OPS8(d, 104), OPS8(d, 112), OPS8(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef OPS8

// ---- epilogue arithmetic (the plain version's results, bit for bit)
// the activations as torch computes them on the card; LeakyReLU 0.01 as
// max(h, 0.01 h), which is h > 0 ? h : 0.01 h for every h, NaN and -0 included
template <int ACT>
__device__ __forceinline__ float activate(float h) {
  if (ACT == ACT_LEAKY) return fmaxf(h, __fmul_rn(h, 0.01f));
  if (ACT == ACT_SILU) return __fdiv_rn(h, __fadd_rn(1.f, expf(-h)));
  return h;
}

template <int ACT>
__device__ __forceinline__ float epilogue(int acc, float deq, float bias) {
  return activate<ACT>(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias));
}

// h / s rounded to nearest even, as __fdiv_rn(h, s), but without its branch
// to a slow path (a branch an element keeps the epilogue from interleaving
// elements, and one warp a scheduler runs it): with inv = __frcp_rn(s), q0 =
// h * inv is within 1.5 ulps, an FMA correction brings it within 1 ulp, and
// a second makes it the correctly rounded quotient (Markstein: inv within
// half an ulp of 1 / s, each remainder h - s * q exact through the FMA).
// That holds while no remainder underflows: for a positive normal scale s
// and |h| > 2^-100, which calibration's scales give; below, the quotient
// rounds to 0 anyway. Past 2^22 (or at infinity) the quotient only has to
// clamp, and q0 is kept; a NaN stays NaN, as with __fdiv_rn.
__device__ __forceinline__ float div_by_scale(float h, float s, float inv) {
  const float q0 = __fmul_rn(h, inv);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, h), inv, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-s, q1, h), inv, q1);
  return fabsf(q0) < 4194304.f ? q2 : q0;
}

// clip(rint(h / s), -127, 127): clipping first, then rounding half to even
// in the conversion, gives the same code for every quotient (NaN: -127)
__device__ __forceinline__ int8_t requant(float h, float s, float inv) {
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(div_by_scale(h, s, inv), -127.f), 127.f)));
}

// the epilogue's shared-memory traffic by 32-bit address: the staging
// stores stay in order with the fences and barriers around them (volatile);
// the deq / bias loads are free to move within a tile (opaque_copy keeps
// them from being hoisted out of the tile loop, which would hold all of
// them in registers)
__device__ __forceinline__ void st_shared_b16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(v));
}

__device__ __forceinline__ void st_shared_v2_f32(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y));
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 ld_shared_v2_f32(uint32_t addr) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t opaque_copy(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// byte offset of byte `byte` of row r in a 128B-swizzled buffer of 128-byte rows
__device__ __forceinline__ int swizzled(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

template <int BN, int ACT, bool OUT_S8>
__global__ void __launch_bounds__(threads(BN, ACT), 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_out, const __grid_constant__ Params p) {
  constexpr int NC = consumers(BN, ACT);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((SMEM_ALIGN - smem_u32(smem_raw) % SMEM_ALIGN) % SMEM_ALIGN);
  const uint32_t base = smem_u32(smem);
  const Plan& pl = p.plan;
  // full[stages], empty[stages], the resident weights, mainloop done[NC]
  const uint32_t full0 = base + pl.bar_offset, empty0 = full0 + 8 * pl.stages;
  const uint32_t b_full = empty0 + 8 * pl.stages, done0 = b_full + 8;
  const int wg = threadIdx.x >> 7;  // consumer warpgroups 0 .. NC - 1; the producer warp is NC
  // this block's N tile, and its M tiles m_first, m_first + m_step, ...
  const int nt = blockIdx.x % pl.n_tiles, m_first = blockIdx.x / pl.n_tiles;
  const int m_step = gridDim.x / pl.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx, then TMA's bytes
      mbar_init(empty0 + 8 * s, 4);  // each warp of the consumer that read it
    }
    mbar_init(b_full, 1);
    for (int i = 0; i < NC; ++i) mbar_init(done0 + 8 * i, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x != 128 * NC) return;
    const int n0 = nt * BN;
    if (pl.resident_b) {  // the block's whole weight tile, once
      mbar_expect_tx(b_full, pl.k_blocks * pl.b_chunk_bytes);
      for (int t = 0, kb = 0; t < pl.taps; ++t)
        for (int cc = 0; cc < pl.chunks; ++cc, ++kb)
          tma_load_3d(base + pl.b_offset + kb * pl.b_chunk_bytes, &tm_b, b_full, cc * K_BLOCK, t,
                      n0);
    }
    const int hw = p.Ho * p.Wo;
    int stage = 0;
    uint32_t phase = 0;
    for (int mt = m_first; mt < pl.m_tiles; mt += m_step) {
      const int m0 = mt * BM;
      // im2col: the top-left input pixel of the window of output pixel m0
      const int b = m0 / hw, r = m0 - b * hw, oy = r / p.Wo, ox = r - oy * p.Wo;
      const int w0 = ox * pl.traversal_stride + pl.box_lower;
      const int h0 = oy * pl.traversal_stride + pl.box_lower;
      for (int t = 0; t < pl.taps; ++t) {
        for (int cc = 0; cc < pl.chunks; ++cc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t st = base + pl.ring_offset + stage * pl.ring_stage_bytes;
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, pl.ring_stage_bytes);
          if (pl.route == ROUTE_IM2COL)
            tma_load_im2col(st, &tm_a, bar, cc * K_BLOCK, w0, h0, b,
                            static_cast<uint16_t>(pl.tap_dx[t]), static_cast<uint16_t>(pl.tap_dy[t]));
          else
            tma_load_2d(st, &tm_a, bar, cc * K_BLOCK, m0);
          if (!pl.resident_b) tma_load_3d(st + pl.a_stage_bytes, &tm_b, bar, cc * K_BLOCK, t, n0);
          if (++stage == pl.stages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int c = wg;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const uint32_t epi = base + pl.epi_offset + c * pl.epi_bufs * SUB_BYTES;
  int ebuf = 0;
  const float s_next = OUT_S8 ? __ldg(p.out_scale) : 1.f, inv_s = __frcp_rn(s_next);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int n0 = nt * BN;
  // deq and bias of the block's N tile, zero past Cout: [BN] each, this consumer's copy
  {
    float* const vec = reinterpret_cast<float*>(smem + pl.vec_offset) + c * 2 * BN;
    for (int i = tid; i < BN; i += 128) {
      const bool ok = n0 + i < p.Cout;
      vec[i] = ok ? __ldg(p.deq + n0 + i) : 0.f;
      vec[BN + i] = ok ? __ldg(p.bias + n0 + i) : 0.f;
    }
  }
  const uint32_t vec = base + pl.vec_offset + c * 2 * BN * 4;
  named_bar_sync(1 + c, 128);
  for (int j = c;; j += NC) {  // this block's tiles j = c, c + NC, ...
    const int mt = m_first + j * m_step;
    if (mt >= pl.m_tiles) break;
    const int m0 = mt * BM;
    // the consumer of tile j - 1 has waited for every stage of it
    if (j > 0) mbar_wait(done0 + 8 * ((j - 1) % NC), ((j - 1) / NC) & 1);
    if (pl.resident_b) mbar_wait(b_full, 0);
    const int it = j * pl.k_blocks;
    int stage = it % pl.stages;
    uint32_t phase = (it / pl.stages) & 1;
    // the ring slot of the k-block `back` k-blocks before the current one
    const auto slot_back = [&](int back) { return stage >= back ? stage - back : stage - back + pl.stages; };
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    for (int kb = 0; kb < pl.k_blocks; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = base + pl.ring_offset + stage * pl.ring_stage_bytes;
      const uint32_t bw =
          pl.resident_b ? base + pl.b_offset + kb * pl.b_chunk_bytes : a + pl.a_stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < K_BLOCK / 32; ++ks)
        wgmma<BN>(acc, sw128_desc(a + 32 * ks), sw128_desc(bw + 32 * ks), (kb | ks) != 0);
      wgmma_commit();
      if (kb >= IN_FLIGHT) {  // the products of k-block kb - IN_FLIGHT are done: free its slot
        wgmma_wait<IN_FLIGHT>();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot_back(IN_FLIGHT));
      }
      if (++stage == pl.stages) stage = 0, phase ^= 1;
    }
    if (lane == 0) mbar_arrive(done0 + 8 * c);  // the next consumer may start its mainloop
    wgmma_wait<0>();
    for (int back = 1; back <= IN_FLIGHT && back <= pl.k_blocks; ++back)
      if (lane == 0) mbar_arrive(empty0 + 8 * slot_back(back));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

    // ------------------------------------------------------------ epilogue
    // accumulator acc[4 jn + 2 h + e] holds row 16 warp + g + 8 h, column
    // 8 jn + 2 tg + e of the tile
    const uint32_t dq_at = opaque_copy(vec), bs_at = dq_at + 4 * BN;
    if (pl.store == STORE_DIRECT) {  // f32 rows that TMA cannot address
      float* out = static_cast<float*>(p.out);
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * jn + 2 * tg + e, n = n0 + col;
          if (n >= p.Cout) continue;
          const float dq = ld_shared_f32(dq_at + 4 * col), bs = ld_shared_f32(bs_at + 4 * col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 16 * warp + g + 8 * h;
            if (row < p.M)
              out[static_cast<long long>(row) * p.Cout + n] = epilogue<ACT>(acc[4 * jn + 2 * h + e], dq, bs);
          }
        }
      continue;
    }
    constexpr int SUB_COLS = OUT_S8 ? 128 : 32;  // a sub-tile row is 128 bytes
#pragma unroll
    for (int sn = 0; sn < BN / SUB_COLS; ++sn) {
      const uint32_t buf = epi + ebuf * SUB_BYTES;
      if (tid == 0) {  // the store that last read this buffer has read it
        if (pl.epi_bufs == 2)
          bulk_wait_read<1>();
        else
          bulk_wait_read<0>();
      }
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int jl = 0; jl < SUB_COLS / 8; ++jl) {
        const int jn = sn * (SUB_COLS / 8) + jl, col = 8 * jn + 2 * tg;
        const bool ok0 = n0 + col < p.Cout, ok1 = n0 + col + 1 < p.Cout;
        const float2 dq = ld_shared_v2_f32(dq_at + 4 * col);
        const float2 bs = ld_shared_v2_f32(bs_at + 4 * col);
        const float d0 = dq.x, d1 = dq.y, b0 = bs.x, b1 = bs.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;
          const int v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
          if (OUT_S8) {
            const uint8_t q0 = ok0 ? requant(epilogue<ACT>(v0, d0, b0), s_next, inv_s) : 0;
            const uint8_t q1 = ok1 ? requant(epilogue<ACT>(v1, d1, b1), s_next, inv_s) : 0;
            st_shared_b16(buf + swizzled(r, 8 * jl + 2 * tg), static_cast<uint16_t>(q0 | q1 << 8));
          } else {
            st_shared_v2_f32(buf + swizzled(r, 4 * (8 * jl + 2 * tg)), epilogue<ACT>(v0, d0, b0),
                             epilogue<ACT>(v1, d1, b1));
          }
        }
      }
      fence_proxy_async();  // the generic writes, visible to TMA
      named_bar_sync(1 + c, 128);
      if (tid == 0) {
        tma_store_2d(&tm_out, buf, n0 + sn * SUB_COLS, m0);
        bulk_commit();
      }
      if (++ebuf == pl.epi_bufs) ebuf = 0;
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ---- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? fn : nullptr;
}

struct Shape {
  int B, H, W, Cp, Cout, Cop, k, stride, pad, Ho, Wo, M;
  bool out_s8;
};

// whether the plan is the one ops/int8_conv.py launch_plan computes for
// this shape and this card: N tiles of 256 for an f32 output where 256
// divides Cout, else 128; the block's whole weight tile resident where it
// fits beside MIN_RESIDENT_STAGES code stages (with two epilogue buffers a
// consumer, else one); the ring as deep as the rest of shared memory allows
bool plan_ok(const Plan& pl, const Shape& s, int act, int sms) {
  const int taps = s.k * s.k, chunks = (s.Cp + K_BLOCK - 1) / K_BLOCK, k_blocks = taps * chunks;
  const bool im2col = s.k > 1, tma = s.out_s8 || s.Cout % 4 == 0;
  const int bn = !s.out_s8 && s.Cout % 256 == 0 ? 256 : 128, nc = consumers(bn, act);
  const int a_stage = BM * K_BLOCK, b_chunk = bn * K_BLOCK, vec = nc * 2 * bn * 4;
  const int room = SMEM_LIMIT - SMEM_ALIGN - BARRIER_BYTES - vec;
  const auto epi = [&](int bufs) { return tma ? nc * bufs * SUB_BYTES : 0; };
  int resident = 0, b_bytes = 0, ring = a_stage + b_chunk, bufs = 2;
  for (int e = 2; e >= 1 && !resident; --e)
    if (k_blocks * b_chunk + MIN_RESIDENT_STAGES * a_stage + epi(e) <= room)
      resident = 1, b_bytes = k_blocks * b_chunk, ring = a_stage, bufs = e;
  Plan w{};
  w.block_m = BM, w.block_n = bn, w.route = im2col ? ROUTE_IM2COL : ROUTE_TILED;
  w.chunks = chunks, w.taps = taps, w.k_blocks = k_blocks;
  w.m_tiles = (s.M + BM - 1) / BM, w.n_tiles = (s.Cout + bn - 1) / bn, w.tiles = w.m_tiles * w.n_tiles;
  w.grid = w.n_tiles * std::max(1, std::min(sms / w.n_tiles, (w.m_tiles + nc - 1) / nc));
  w.stages = std::min(MAX_STAGES, (room - b_bytes - epi(bufs)) / ring);
  w.resident_b = resident, w.store = tma ? STORE_TMA : STORE_DIRECT, w.epi_bufs = tma ? bufs : 0;
  w.a_stage_bytes = a_stage, w.b_chunk_bytes = b_chunk, w.ring_stage_bytes = ring;
  w.b_offset = 0, w.ring_offset = b_bytes, w.epi_offset = w.ring_offset + w.stages * ring;
  w.vec_offset = w.epi_offset + epi(bufs), w.bar_offset = w.vec_offset + vec;
  w.smem_bytes = SMEM_ALIGN + w.bar_offset + BARRIER_BYTES;
  w.box_lower = im2col ? -s.pad : 0, w.box_upper = im2col ? s.pad - (s.k - 1) : 0;
  w.traversal_stride = s.stride, w.consumers = nc;
  for (int t = 0; t < taps && t < MAX_TAPS; ++t) w.tap_dx[t] = t % s.k, w.tap_dy[t] = t / s.k;
  return memcmp(&w, &pl, sizeof(Plan)) == 0 && taps <= MAX_TAPS && w.grid <= sms &&
         w.stages > IN_FLIGHT && w.smem_bytes <= SMEM_LIMIT &&
         (2 * w.stages + 1 + nc) * 8 <= BARRIER_BYTES;
}

int encode_maps(const Plan& pl, const Shape& s, const void* x, const void* w, void* out,
                CUtensorMap* ma, CUtensorMap* mb, CUtensorMap* mo) {
  static const auto tiled = reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  static const auto im2col =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (!tiled || !im2col) return ERR_DRIVER_ENTRY;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto none = CU_TENSOR_MAP_INTERLEAVE_NONE;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto zero_fill = CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE;
  const cuuint64_t cp = s.Cp;
  CUresult r;
  if (pl.route == ROUTE_IM2COL) {  // (B, H, W, Cp) codes
    const cuuint64_t dims[4] = {cp, (cuuint64_t)s.W, (cuuint64_t)s.H, (cuuint64_t)s.B};
    const cuuint64_t strides[3] = {cp, cp * s.W, cp * s.W * s.H};
    const int lower[2] = {pl.box_lower, pl.box_lower}, upper[2] = {pl.box_upper, pl.box_upper};
    const cuuint32_t estr[4] = {1, (cuuint32_t)s.stride, (cuuint32_t)s.stride, 1};
    r = im2col(ma, u8, 4, const_cast<void*>(x), dims, strides, lower, upper, K_BLOCK,
               pl.block_m, estr, none, sw128, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, zero_fill);
  } else {  // the [M, Cp] code matrix
    const cuuint64_t dims[2] = {cp, (cuuint64_t)s.M};
    const cuuint64_t strides[1] = {cp};
    const cuuint32_t box[2] = {K_BLOCK, (cuuint32_t)pl.block_m}, estr[2] = {1, 1};
    r = tiled(ma, u8, 2, const_cast<void*>(x), dims, strides, box, estr, none, sw128,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, zero_fill);
  }
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  {  // [Cout, taps, Cp] weights
    const cuuint64_t dims[3] = {cp, (cuuint64_t)(s.k * s.k), (cuuint64_t)s.Cout};
    const cuuint64_t strides[2] = {cp, cp * s.k * s.k};
    const cuuint32_t box[3] = {K_BLOCK, 1, (cuuint32_t)pl.block_n}, estr[3] = {1, 1, 1};
    r = tiled(mb, u8, 3, const_cast<void*>(w), dims, strides, box, estr, none, sw128,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, zero_fill);
  }
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  if (pl.store == STORE_TMA) {  // [M, Cop] int8 or [M, Cout] f32, sub-tiles of 64 x 128 bytes
    const int esize = s.out_s8 ? 1 : 4, cols = s.out_s8 ? s.Cop : s.Cout;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)s.M};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), BM}, estr[2] = {1, 1};
    r = tiled(mo, s.out_s8 ? u8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box,
              estr, none, sw128, CU_TENSOR_MAP_L2_PROMOTION_NONE, zero_fill);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  }
  return 0;
}

template <int BN, int ACT, bool OUT_S8>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mo, const Params& p,
           cudaStream_t stream) {
  auto kernel = int8_conv_kernel<BN, ACT, OUT_S8>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             p.plan.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<p.plan.grid, threads(BN, ACT), p.plan.smem_bytes, stream>>>(ma, mb, mo, p);
  return (int)cudaGetLastError();
}

// N tiles of 256 for f32 outputs only (int8 outputs take 128)
template <int ACT>
int launch_tile(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mo,
                const Params& p, bool out_s8, cudaStream_t stream) {
  if (out_s8) return launch<128, ACT, true>(ma, mb, mo, p, stream);
  return p.plan.block_n == 256 ? launch<256, ACT, false>(ma, mb, mo, p, stream)
                               : launch<128, ACT, false>(ma, mb, mo, p, stream);
}

}  // namespace

// x: (B, H, W, Cp) int8 codes, Cp a multiple of 32; w: (Cout, k, k, Cp) int8;
// deq, bias: (Cout,) f32; out_scale: one f32 (read when out_s8 != 0, may be
// null otherwise); out: f32 (B, Ho, Wo, Cout) for out_s8 == 0, int8
// (B, Ho, Wo, Cop) with Cop = Cout rounded up to 32 otherwise. x, w and out
// 16-byte aligned; all device pointers, contiguous. act: 0 identity, 1
// LeakyReLU 0.01, 2 SiLU. plan: plan_len ints, ops/int8_conv.py
// LaunchPlan.to_array() for this shape. Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for arguments or a plan
// it does not take, ERR_DRIVER_ENTRY / ERR_ENCODE + CUresult if a tensor
// map cannot be made.
extern "C" int yogo_int8_conv_launch(const void* x, const void* w, const void* deq,
                                     const void* bias, const void* out_scale, void* out, int B,
                                     int H, int W, int Cp, int Cout, int k, int stride, int pad,
                                     int act, int out_s8, const int* plan, int plan_len,
                                     void* stream) {
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (B <= 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 32 || Cout <= 0 || k <= 0 || stride <= 0 ||
      pad < 0 || act < 0 || act > 2 || (out_s8 && !out_scale) || misaligned(x) ||
      misaligned(w) || misaligned(out) || !plan || plan_len != PLAN_LEN)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = B, s.H = H, s.W = W, s.Cp = Cp, s.Cout = Cout, s.Cop = (Cout + 31) / 32 * 32;
  s.k = k, s.stride = stride, s.pad = pad, s.out_s8 = out_s8 != 0;
  s.Ho = (H + 2 * pad - k) / stride + 1;
  s.Wo = (W + 2 * pad - k) / stride + 1;
  const long long M = (long long)B * s.Ho * s.Wo;
  if (s.Ho <= 0 || s.Wo <= 0 || M > 0x7fffffffLL || (long long)B * H * W * Cp > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  s.M = (int)M;
  Params p;
  for (int i = 0; i < PLAN_LEN; ++i) reinterpret_cast<int*>(&p.plan)[i] = plan[i];
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (!plan_ok(p.plan, s, act, sms)) return (int)cudaErrorInvalidValue;
  p.deq = static_cast<const float*>(deq);
  p.bias = static_cast<const float*>(bias);
  p.out_scale = static_cast<const float*>(out_scale);
  p.out = out;
  p.M = s.M, p.Cout = Cout, p.Ho = s.Ho, p.Wo = s.Wo;
  CUtensorMap ma, mb, mo = {};
  const int m = encode_maps(p.plan, s, x, w, out, &ma, &mb, &mo);
  if (m != 0) return m;
  auto st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ACT_LEAKY: return launch_tile<ACT_LEAKY>(ma, mb, mo, p, s.out_s8, st);
    case ACT_SILU: return launch_tile<ACT_SILU>(ma, mb, mo, p, s.out_s8, st);
    default: return launch_tile<ACT_NONE>(ma, mb, mo, p, s.out_s8, st);
  }
}

extern "C" const char* yogo_cuda_error_string(int code) {
  static thread_local char msg[96];
  if (code == ERR_DRIVER_ENTRY) return "cuTensorMapEncode* not found through cudaGetDriverEntryPoint";
  if (code >= ERR_ENCODE) {
    snprintf(msg, sizeof msg, "cuTensorMapEncode* failed with CUresult %d", code - ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
