// Greedy non-maximal suppression for Hopper (sm_90a), batched over images:
// one launch resolves what ops/nms.py batched_nms_reference computes with a
// B x K x K chain of torch ops and a fixed-point loop that asks the host,
// round after round, whether `keep` still changes.
//
// Replaces the XLA `while_loop` of the JAX package's NMS
// (yogo_tpu/ops/nms.py:68-89, greedy keep resolved by fixed-point iteration
// on the device). There is no Pallas kernel behind it; the port's loop ran on
// the host, one device-to-host sync a round, which held the host in lockstep
// with the card in every count.
//
// For each image, over the K slots (boxes xyxy f32, scores f32, valid,
// int64 tiebreak):
//   i precedes j   iff  s_i > s_j, or s_i == s_j and tb_i < tb_j
//                       (a NaN score counts as -inf);
//   i suppresses j iff  i precedes j, both are valid and IoU(i, j) > thr;
//   keep[j]        iff  j is valid and no kept i suppresses j,
// which is sequential greedy NMS in the (score desc, tiebreak asc) order.
// The IoU is the torch chain's, op for op, in f32 round-to-nearest with no
// FMA contraction and an IEEE divide, NaN-propagating where a NaN can arise:
//   ext = clamp(x2 - x1, 0, 1e19), area = ext_w * ext_h,
//   wh = clamp(min(x2_i, x2_j) - max(x1_i, x1_j), 0, 1e19), inter = wh_x * wh_y,
//   iou = inter / ((area_i + area_j) - inter).
// So `keep` equals the plain version's bit for bit; a NaN IoU never
// suppresses.
//
// Bound: latency. The greedy scan is serial, one step a valid slot in rank
// order, after a block's barriers and first loads; the bytes (29 B a slot
// in, 1 B out: 0.49 MB at B=64, K=256, 0.15 us at 3.35 TB/s) and the
// nv^2/2 IoUs of an image are small beside them at the count's 20-60 valid
// slots an image. Design, one block an image (B blocks):
//   1. the valid slots are compacted in slot order (a ballot prefix sum);
//   2. each valid slot is ranked by counting the slots before it in
//      (score desc, tiebreak asc, slot asc) order, and its box, area, score
//      and tiebreak are written at its rank;
//   3. the warps fill the rank-ordered suppression bitmask, a row a warp
//      and a pair a lane (row r, bit s: rank r suppresses rank s > r;
//      ceil(nv/64) words a row, nv the valid slots, at an odd row stride):
//      no step waits on another;
//   4. one warp scans the ranks in order, 64 at a time in registers: a rank
//      not removed by a kept rank before it is kept;
//   5. each valid slot's keep is written at its slot (invalid slots 0).
// The workspace (bitmask and the per-slot arrays, sized by K: 25,856 B an
// image at K=256, 201,728 B at 1,024) is a global scratch the caller
// allocates; at the count's B=64, K=256 (1.65 MB) it stays in L2.
//
// Built by yogo_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below, no torch headers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr float EXT_LIM = 1e19f;  // 1e19^2 = 1e38 < f32 max: areas never overflow

typedef unsigned long long u64;

// Byte offsets of one image's workspace for K slots, widest first, so each
// array is aligned; an image's total is a multiple of 256. ops/nms.py's
// _workspace_bytes gives the same total, and the launch checks it.
struct Layout {
  size_t ck_box, r_box, mask, ck_tb, r_tb, ck_score, r_score, r_area, ck_slot,
      r_slot, kept, total;
};

__host__ __device__ inline Layout layout(int K) {
  const size_t k = (size_t)K, nw = (k + 63) / 64;
  Layout l;
  size_t o = 0;
  l.ck_box = o;   o += 16 * k;      // float4, compact (slot order of the valid)
  l.r_box = o;    o += 16 * k;      // float4, by rank
  l.mask = o;     o += 8 * k * nw;  // u64 [K][nw]
  l.ck_tb = o;    o += 8 * k;       // i64
  l.r_tb = o;     o += 8 * k;
  l.ck_score = o; o += 4 * k;       // f32, NaN -> -inf
  l.r_score = o;  o += 4 * k;
  l.r_area = o;   o += 4 * k;
  l.ck_slot = o;  o += 4 * k;       // i32
  l.r_slot = o;   o += 4 * k;
  l.kept = o;     o += k;           // u8, by rank
  l.total = (o + 255) / 256 * 256;
  return l;
}

// torch.clamp(v, 0, 1e19) on the card: NaN in, NaN out
__device__ __forceinline__ float t_clamp(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), EXT_LIM);
}

// iou(a, b) > thr as the torch chain computes it. A NaN area (a NaN
// coordinate, or inf - inf) makes the union, so the IoU, NaN: never above.
// Otherwise no coordinate is NaN, and min(x2) - max(x1) is never inf - inf
// (that box's own extent would be NaN), so min / max / clamp need no NaN
// care. inter == 0 gives 0 / denom: +-0 for denom > 0 and NaN for denom 0
// (denom >= 0, as areas are), so the divide is skipped there with the same
// answer.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float thr) {
  if (isnan(area_a) || isnan(area_b)) return false;
  const float wx = fminf(fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f), EXT_LIM);
  const float wy = fminf(fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f), EXT_LIM);
  const float inter = __fmul_rn(wx, wy);
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (inter == 0.f) return denom > 0.f && 0.f > thr;
  return __fdiv_rn(inter, denom) > thr;
}

__global__ void __launch_bounds__(THREADS, 1)
    nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
               const uint8_t* __restrict__ valid, const long long* __restrict__ tiebreak,
               float thr, int K, uint8_t* __restrict__ out, uint8_t* __restrict__ scratch) {
  __shared__ int warp_count[THREADS / 32];
  const Layout L = layout(K);
  uint8_t* ws = scratch + (size_t)blockIdx.x * L.total;
  u64* mask = reinterpret_cast<u64*>(ws + L.mask);
  long long* ck_tb = reinterpret_cast<long long*>(ws + L.ck_tb);
  long long* r_tb = reinterpret_cast<long long*>(ws + L.r_tb);
  float4* ck_box = reinterpret_cast<float4*>(ws + L.ck_box);
  float4* r_box = reinterpret_cast<float4*>(ws + L.r_box);
  float* ck_score = reinterpret_cast<float*>(ws + L.ck_score);
  float* r_score = reinterpret_cast<float*>(ws + L.r_score);
  float* r_area = reinterpret_cast<float*>(ws + L.r_area);
  int* ck_slot = reinterpret_cast<int*>(ws + L.ck_slot);
  int* r_slot = reinterpret_cast<int*>(ws + L.r_slot);
  uint8_t* kept = ws + L.kept;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * K;

  // 1. compact the valid slots in slot order; invalid slots are answered now
  int nv = 0;  // the same in every thread
  for (int j0 = 0; j0 < K; j0 += THREADS) {
    const int j = j0 + tid;
    const bool v = j < K && valid[base + j];
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = nv, chunk = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? warp_count[w] : 0;
      chunk += warp_count[w];
    }
    if (v) {
      const int c = before + __popc(ballot & ((1u << lane) - 1u));
      const float* bp = boxes + (base + j) * 4;
      const float s = scores[base + j];
      ck_box[c] = make_float4(bp[0], bp[1], bp[2], bp[3]);
      ck_score[c] = isnan(s) ? __int_as_float(0xff800000) : s;  // -inf
      ck_tb[c] = tiebreak[base + j];
      ck_slot[c] = j;
    } else if (j < K) {
      out[base + j] = 0;
    }
    nv += chunk;
    __syncthreads();
  }
  if (nv == 0) return;
  const int nw = (nv + 63) >> 6;  // words a bitmask row

  // 2. rank: the slots before c in (score desc, tiebreak asc, slot asc)
  for (int c = tid; c < nv; c += THREADS) {
    const float s = ck_score[c];
    const long long t = ck_tb[c];
    int rank = 0;
    for (int d = 0; d < nv; ++d) {
      const float sd = ck_score[d];
      const long long td = ck_tb[d];
      rank += (sd > s) || (sd == s && (td < t || (td == t && d < c)));
    }
    const float4 b = ck_box[c];
    r_box[rank] = b;
    r_area[rank] = __fmul_rn(t_clamp(__fsub_rn(b.z, b.x)), t_clamp(__fsub_rn(b.w, b.y)));
    r_score[rank] = s;
    r_tb[rank] = t;
    r_slot[rank] = ck_slot[c];
  }
  __syncthreads();

  // 3. the suppression bitmask by rank: word (r, w) holds bits s in
  // [64w, 64w + 64), a row a warp (rows dealt round the warps), a word at a
  // time, a lane two pairs (s = 64w + lane and + 32), gathered with
  // __ballot_sync. Words left of the diagonal (w < r / 64) hold no successor
  // of r and are never read: not written.
  for (int r = warp; r < nv; r += THREADS / 32) {
    const float4 a = r_box[r];
    const float area_a = r_area[r], sa = r_score[r];
    const long long ta = r_tb[r];
    for (int w = r >> 6; w < nw; ++w) {
      u64 bits = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = (w << 6) + 32 * half + lane;
        bool sup = false;
        if (s > r && s < nv) {
          const float ss = r_score[s];
          sup = (sa > ss || (sa == ss && ta < r_tb[s])) &&
                iou_above(a, area_a, r_box[s], r_area[s], thr);
        }
        bits |= (u64)__ballot_sync(0xffffffffu, sup) << (32 * half);
      }
      if (lane == 0) mask[(size_t)r * nw + w] = bits;
    }
  }
  __syncthreads();

  // 4. the greedy scan, one warp, 64 ranks (one word column wb) at a time.
  // The ranks of column wb removed by kept ranks of earlier columns: an OR
  // down the column over those rows, a row a lane. Then the serial part runs
  // in registers: `cur` (the removed bits of the 64) and each rank's
  // diagonal word, held by the lanes and shuffled in, off the chain of
  // dependent steps.
  if (warp == 0) {
    for (int wb = 0; wb < nw; ++wb) {
      const int r0 = wb << 6, n = min(64, nv - r0);
      u64 cur = 0;
      for (int r = lane; r < r0; r += 32)
        if (kept[r]) cur |= mask[(size_t)r * nw + wb];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cur |= __shfl_xor_sync(0xffffffffu, cur, o);
      const u64 d0 = lane < n ? mask[(size_t)(r0 + lane) * nw + wb] : 0;
      const u64 d1 = lane + 32 < n ? mask[(size_t)(r0 + 32 + lane) * nw + wb] : 0;
      u64 keep = 0;
#pragma unroll
      for (int t = 0; t < 64; ++t) {
        const u64 row = __shfl_sync(0xffffffffu, t < 32 ? d0 : d1, t & 31);
        if (t < n && !((cur >> t) & 1ull)) {
          keep |= 1ull << t;
          cur |= row;
        }
      }
      if (lane < n) kept[r0 + lane] = (keep >> lane) & 1ull;
      if (lane + 32 < n) kept[r0 + 32 + lane] = (keep >> (lane + 32)) & 1ull;
      __syncwarp();
    }
  }
  __syncthreads();

  // 5. keep of each valid slot, at its slot
  for (int r = tid; r < nv; r += THREADS) out[base + r_slot[r]] = kept[r];
}

}  // namespace

// boxes: (B, K, 4) f32 xyxy; scores: (B, K) f32; valid: (B, K) bool (one byte,
// 0 / 1); tiebreak: (B, K) int64; out: (B, K) bool, keep & valid in slot
// order; scratch: scratch_bytes of workspace, at least B times an image's.
// All device pointers, contiguous. Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int yogo_nms_launch(const void* boxes, const void* scores, const void* valid,
                               const void* tiebreak, float thr, int B, int K, void* out,
                               void* scratch, long long scratch_bytes, void* stream) {
  if (B <= 0 || K <= 0 || scratch == nullptr ||
      scratch_bytes < (long long)B * (long long)layout(K).total)
    return (int)cudaErrorInvalidValue;
  nms_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<const long long*>(tiebreak), thr, K,
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" const char* yogo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
