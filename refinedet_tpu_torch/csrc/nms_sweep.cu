// K1: batched greedy hard-NMS suppression sweep for Hopper (sm_90a).
//
// Replaces refinedet_tpu/ops/nms_pallas.py:_nms_sweep_kernel. One block per
// group of K score-descending candidates, in two overlapped phases:
//
//  * Build (warps 1..7, the producers). The upper-triangle suppression
//    bitmask: bit b of mask[i][w] is set iff column j = 64w + b > i and
//    iou(i, j) > thresh. The rows come in stripes of 64; a stripe holds only
//    the words at or right of its diagonal, so stripe s has 64 x (W - s)
//    words for W = ceil(K / 64). A producer warp computes 32 rows x one word
//    at a time: each lane holds its row's box in registers, the warp stages
//    the word's 64 column boxes and areas in its own slice of shared memory,
//    and each lane produces a whole 64-bit word. A prefilter of one fused
//    multiply-add a pair spares the IEEE division for the pairs whose IoU
//    provably cannot exceed the threshold, most of them; only invalid rows
//    and columns, and columns at or left of the row, are not tested at all.
//  * Sweep (warp 0). Lane l holds the "removed" words l, l+32, ... in
//    registers, seeded with the invalid columns and those at or past K. It
//    takes a word (64 columns) at a time. Inside word s the greedy is
//    settled as a fixed point over the word's 64 diagonal words, two a lane:
//    a row that no row still possibly kept suppresses is kept, a row that a
//    kept row suppresses is removed, and each round (two warp OR-reductions)
//    settles at least the first undecided row; rows that do not interact
//    settle together, so a round settles many. Then each lane ORs the rows
//    kept in word s into its later words, reads that do not depend on each
//    other. The sweep stops after the group's last valid column, or as soon
//    as no later column is open; what was never removed is the keep mask.
//
// The stripes pass through a ring of `depth` slots in shared memory, with
// one full and one empty mbarrier a slot: a hand-off per stripe, at most
// ceil(K / 64) a group, plus one __syncthreads at the start. No barrier of
// the block is taken per kept row, and no chain of dependent steps is as
// long as the number of kept rows.
//
// What bounds it on this card: the build, at both main shapes. It tests the
// valid pairs of the upper triangle, K^2/2 for a group, where greedy NMS
// needs only those after a kept row; each test is ~16 instructions (six of
// them min/max), issued by the groups side by side on every SM. The sweep
// hides behind it but for the last stripe. Bytes (18 a candidate) never
// bound it.
//
// IoU is computed op for op like the plain version (ops/nms.py:
// nms_sweep_reference) so that keep masks are bitwise identical: build with
// --fmad=false and keep the IEEE division. A NaN IoU (a pair of zero-area
// boxes) must not suppress, hence `iou > thresh` and never
// `!(iou <= thresh)`.
//
// C interface (loaded with ctypes by ops/nms_cuda.py):
//   int nms_sweep_launch(const float* boxes /*[G,K,4]*/,
//                        const uint8_t* valid /*[G,K]*/,
//                        uint8_t* keep /*[G,K]*/, int g, int k,
//                        float iou_thresh, int plus_one, void* stream);
// returns cudaGetLastError() after the launch (0 on success).
//   int nms_sweep_max_k();  // the largest K it takes

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // warp 0 sweeps, warps 1..7 build
constexpr int kWarps = kThreads / 32;
constexpr int kProducers = kWarps - 1;
constexpr int kStripe = 64;         // rows a stripe = columns a word
constexpr int kWordsPerLane = 6;    // removed words a sweep lane holds
constexpr int kMaxWords = 32 * kWordsPerLane;  // so K <= 12288
constexpr int kRingBudget = 32 * 1024;  // bytes; below it the depth is >= 2
constexpr int kMaxSmem = 227 * 1024;    // a block's shared memory on Hopper

// Ring slots for K: as many stripes as fit the budget, at least two (one
// being swept, one being built), at most all of them.
int ring_depth(int words) {
  const int slot = kStripe * words * static_cast<int>(sizeof(uint64_t));
  int depth = kRingBudget / slot;
  if (depth < 2) depth = 2;
  return depth < words ? depth : words;
}

size_t smem_bytes(int words, int depth) {
  return sizeof(uint64_t) * depth * kStripe * words          // ring
         + (sizeof(float4) + sizeof(float)) * kProducers * 64  // column tiles
         + sizeof(uint64_t) * words                            // valid words
         + sizeof(uint64_t) * 2 * depth;                       // mbarriers
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  const uint32_t hi = __reduce_or_sync(~0u, static_cast<uint32_t>(v >> 32));
  const uint32_t lo = __reduce_or_sync(~0u, static_cast<uint32_t>(v));
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// + 1 in the pixel-area convention. In the other the plain version adds
// 0.0, which can change only the sign of a zero; no comparison the kernel
// makes reads that sign (an IoU of +-0 or +-0/+-0 compares the same), so
// the add is left out there.
template <bool kPlusOne>
__device__ __forceinline__ float plus(float x) {
  return kPlusOne ? x + 1.0f : x;
}

template <bool kPlusOne>
__device__ __forceinline__ float area(float4 b) {
  return plus<kPlusOne>(b.z - b.x) * plus<kPlusOne>(b.w - b.y);
}

// Intersection and union of row box `a` (area aa) and column box `b` (area
// ab), op for op the plain version's: min/max, + 1 (see plus), clamp at 0,
// then (aa + ab) - inter. The IoU is inter / uni.
template <bool kPlusOne>
__device__ __forceinline__ void overlap(float4 a, float aa, float4 b,
                                        float ab, float& inter, float& uni) {
  const float iw =
      fmaxf(plus<kPlusOne>(fminf(a.z, b.z) - fmaxf(a.x, b.x)), 0.0f);
  const float ih =
      fmaxf(plus<kPlusOne>(fminf(a.w, b.w) - fmaxf(a.y, b.y)), 0.0f);
  inter = iw * ih;
  uni = (aa + ab) - inter;
}

// The prefilter, for t in [2^-20, 1]: a pair may suppress only if
// fl(inter - tc * uni) >= 0, one fused multiply-add, with
// tc = fl(t (1 - 2^-20)). A negative result means inter < tc * uni exactly,
// and tc <= t (1 - 2^-20) (1 + 2^-24) < t, so for uni > 0 the quotient
// inter / uni is below t and rounds to at most t. For uni <= 0 the result
// is >= 0 (inter is >= 0 or -0), and it is NaN only if inter or uni is NaN
// or both are +inf, where the IoU is NaN too. So no hit is lost. For any
// other t (tc = 0) every pair goes to the division.
__device__ __forceinline__ float prefilter_scale(float t) {
  return t >= 0x1p-20f && t <= 1.0f ? t * (1.0f - 0x1p-20f) : 0.0f;
}

__device__ __forceinline__ bool may_suppress(float inter, float uni,
                                             float tc) {
  return fmaf(-tc, uni, inter) >= 0.0f;
}

// The other side: a pair surely suppresses if uni > 0 and
// fl(inter - th * uni) > 0, th = fl(t (1 + 2^-20)) for t in [2^-20, 1].
// Then inter / uni > th >= t (1 + 2^-20) (1 - 2^-24) > t + ulp(t), so the
// rounded quotient is above t. For any other t, th = +inf decides nothing.
__device__ __forceinline__ float sure_scale(float t) {
  const float inf = __int_as_float(0x7f800000);
  return t >= 0x1p-20f && t <= 1.0f ? t * (1.0f + 0x1p-20f) : inf;
}

__device__ __forceinline__ bool surely_suppresses(float inter, float uni,
                                                  float th) {
  return uni > 0.0f && fmaf(-th, uni, inter) > 0.0f;
}

// mask[i][w] for this lane's row box `a` against the 64 column boxes of
// the tile, for the bits of `want` only. A first pass of cheap tests marks
// the columns that may be hit; of those, the clear hits are told by one
// more fused multiply-add, and only the rest pay the IEEE division.
template <bool kPlusOne>
__device__ __forceinline__ uint64_t row_word(float4 a, float aa,
                                             const float4* tb,
                                             const float* ta, uint64_t want,
                                             float t, float tc, float th) {
  const float4* ta4 = reinterpret_cast<const float4*>(ta);
  uint32_t half[2] = {~0u, ~0u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tc == 0.0f || !static_cast<uint32_t>(want >> (32 * h))) continue;
    half[h] = 0;
#pragma unroll
    for (int c4 = 0; c4 < 8; ++c4) {
      const float4 a4 = ta4[8 * h + c4];
      const float areas[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float inter, uni;
        overlap<kPlusOne>(a, aa, tb[32 * h + 4 * c4 + e], areas[e], inter,
                          uni);
        if (may_suppress(inter, uni, tc)) half[h] |= 1u << (4 * c4 + e);
      }
    }
  }
  const uint32_t lo = half[0], hi = half[1];
  uint64_t may = (static_cast<uint64_t>(hi) << 32 | lo) & want;
  uint64_t word = 0;
  while (may) {
    const int c = __ffsll(may) - 1;
    may &= may - 1;
    float inter, uni;
    overlap<kPlusOne>(a, aa, tb[c], ta[c], inter, uni);
    bool hit = surely_suppresses(inter, uni, th);
    // With the prefilter on (t > 0) an empty intersection cannot hit; it
    // would only take the division's slow path, for 0 / 0.
    if (!hit && (tc == 0.0f || inter > 0.0f))
      hit = inter / uni > t;  // a NaN IoU never suppresses
    if (hit) word |= 1ull << c;
  }
  return word;
}

template <bool kPlusOne>
__global__ void __launch_bounds__(kThreads, 5)
nms_sweep_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k, int depth,
                 float iou_thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (k + kStripe - 1) / kStripe;  // words a row
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);  // [depth][64][nw]
  float4* tile_box = reinterpret_cast<float4*>(
      ring + static_cast<size_t>(depth) * kStripe * nw);  // [7][64]
  float* tile_area = reinterpret_cast<float*>(tile_box + kProducers * 64);
  // the valid flags as words, and at the end the keep mask's
  uint64_t* vwords = reinterpret_cast<uint64_t*>(tile_area + kProducers * 64);
  uint64_t* full = vwords + nw;   // [depth], a producer thread's arrival each
  uint64_t* empty = full + depth;  // [depth], a sweep lane's arrival each
  __shared__ int last_of_warp[kWarps];
  __shared__ int sweep_done;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;

  if (tid == 0) {
    for (int d = 0; d < depth; ++d) {
      mbar_init(&full[d], kProducers * 32);
      mbar_init(&empty[d], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sweep_done = 0;
  }
  // Valid flags as 64-bit words, and the last valid column.
  int last = -1;
  for (int w = warp; w < nw; w += kWarps) {
    const int j = w * kStripe + lane;
    const uint32_t lo = __ballot_sync(~0u, j < k && valid[base + j]);
    const uint32_t hi =
        __ballot_sync(~0u, j + 32 < k && valid[base + j + 32]);
    const uint64_t word = static_cast<uint64_t>(hi) << 32 | lo;
    if (lane == 0) vwords[w] = word;
    if (word) last = w * kStripe + 63 - __clzll(word);
  }
  if (lane == 0) last_of_warp[warp] = last;
  __syncthreads();
  int n_rows = 0;  // rows after the last valid one never suppress
  for (int i = 0; i < kWarps; ++i) n_rows = max(n_rows, last_of_warp[i] + 1);
  const int stripes = (n_rows + kStripe - 1) / kStripe;

  if (warp > 0) {
    // ---- build: stripe by stripe into the ring ----
    const float tc = prefilter_scale(iou_thresh);
    const float th = sure_scale(iou_thresh);
    float4* tb = tile_box + (warp - 1) * 64;
    float* ta = tile_area + (warp - 1) * 64;
    // Tasks are dealt round robin across the stripes, so no warp takes the
    // first task of every stripe.
    int first = warp - 1;
    for (int s = 0; s < stripes; ++s) {
      const int slot = s % depth;
      if (s >= depth) mbar_wait(&empty[slot], ((s / depth) & 1) ^ 1);
      const int done =
          __shfl_sync(~0u, *reinterpret_cast<volatile int*>(&sweep_done), 0);
      if (!done) {
        uint64_t* out = ring + static_cast<size_t>(slot) * kStripe * nw;
        const int halves = min(2, (n_rows - s * kStripe + 31) / 32);
        const int tasks = halves * (nw - s);
        for (int t = first; t < tasks; t += kProducers) {
          const int h = t % halves, w = s + t / halves;
          // A half-stripe with no valid row is never read by the sweep.
          if (!static_cast<uint32_t>(vwords[s] >> (32 * h))) continue;
          const int r = h * 32 + lane;  // row in the stripe
          const int i = s * kStripe + r;
          // A box whose area is not > 0 has a width or height <= 0, or a
          // product that underflows (then so does the intersection, which
          // is no wider and no higher), or a NaN: its intersections are 0
          // or its unions NaN. With the prefilter on (t > 0) it hits
          // nothing and nothing hits it, so its pairs are not tested.
          uint64_t solid = 0;
#pragma unroll
          for (int c = lane; c < 64; c += 32) {
            const int j = w * kStripe + c;
            const float4 b =
                j < k ? boxes[base + j] : make_float4(0, 0, 0, 0);
            tb[c] = b;
            ta[c] = area<kPlusOne>(b);
            solid |= static_cast<uint64_t>(
                         __ballot_sync(~0u, tc == 0.0f || ta[c] > 0.0f))
                     << (c - lane);
          }
          const float4 bi =
              i < k ? boxes[base + i] : make_float4(0, 0, 0, 0);
          const float ai = area<kPlusOne>(bi);
          // Of a valid row, the valid columns j > i only; nothing of an
          // invalid row: the sweep reads no other bit.
          const uint64_t want =
              (vwords[s] >> r) & 1 && (tc == 0.0f || ai > 0.0f)
                  ? vwords[w] & solid &
                        (w != s ? ~0ull : r == 63 ? 0ull : ~0ull << (r + 1))
                  : 0ull;
          __syncwarp();
          out[r * nw + w] =
              row_word<kPlusOne>(bi, ai, tb, ta, want, iou_thresh, tc, th);
          __syncwarp();  // the tile is read before the next task writes it
        }
        first = (first + kProducers - tasks % kProducers) % kProducers;
      }
      mbar_arrive(&full[slot]);
    }
    return;
  }

  // ---- sweep: warp 0 ----
  uint64_t removed[kWordsPerLane];
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    const int w = lane + 32 * q;
    removed[q] = w < nw ? ~vwords[w] : ~0ull;  // invalid, or at or past K
  }
  int ready = 0, released = 0;  // stripes waited for, stripes handed back
  // Waits until stripe `s` is in the ring; hands back every stripe before.
  auto need = [&](int s) {
    while (ready <= s) {
      while (released < ready) mbar_arrive(&empty[released++ % depth]);
      mbar_wait(&full[ready % depth], (ready / depth) & 1);
      ++ready;
    }
  };
  const int nq = (nw + 31) / 32;  // words a lane holds for this K
  for (int s = 0; s < stripes; ++s) {
    need(s);
    const uint64_t* rows =
        ring + static_cast<size_t>(s % depth) * kStripe * nw;
    // Word s from its lane, to every lane.
    uint64_t word = 0;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q)
      if (q == s / 32) word = removed[q];
    word = __shfl_sync(~0u, word, s % 32);
    // The greedy inside word s, as a fixed point. Lane l holds the
    // diagonal words of rows l and l + 32. A row nobody still possibly
    // kept suppresses is kept; a row a kept row suppresses is removed.
    // Each round settles at least the first undecided row, and rows that
    // do not interact settle together.
    const uint64_t d_lo = rows[lane * nw + s];
    const uint64_t d_hi = rows[(lane + 32) * nw + s];
    uint64_t kept = 0, undecided = ~word;
    while (undecided) {
      const uint64_t alive = kept | undecided;
      const uint64_t maybe = ((alive >> lane) & 1 ? d_lo : 0) |
                             ((alive >> (lane + 32)) & 1 ? d_hi : 0);
      const uint64_t sure = ((kept >> lane) & 1 ? d_lo : 0) |
                            ((kept >> (lane + 32)) & 1 ? d_hi : 0);
      const uint64_t hit_maybe = warp_or(maybe), hit_sure = warp_or(sure);
      kept |= undecided & ~hit_maybe;
      undecided &= hit_maybe & ~hit_sure;
    }
    // Every later word takes the rows kept in word s: independent reads.
    bool open_after = false;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int w = lane + 32 * q;
      if (w == s) removed[q] = ~kept;
      if (q < nq && w > s && w < nw) {
        uint64_t hit = 0;
        for (int b = 0; b < kStripe; ++b)
          if ((kept >> b) & 1) hit |= rows[b * nw + w];
        removed[q] |= hit;
        open_after |= ~removed[q] != 0;
      }
    }
    if (!__any_sync(~0u, open_after)) break;  // nothing left to keep
  }
  if (lane == 0) *reinterpret_cast<volatile int*>(&sweep_done) = 1;

  // Producers still waiting for a slot get it back; they skip the build.
  // Once every stripe is through, no producer reads the valid words again.
  if (stripes > 0) need(stripes - 1);
  // keep = never removed, written through shared memory so that each
  // store covers 32 consecutive columns.
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    const int w = lane + 32 * q;
    if (w < nw) vwords[w] = removed[q];
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32)
    keep[base + j] = !((vwords[j / kStripe] >> (j % kStripe)) & 1);
}

}  // namespace

extern "C" int nms_sweep_max_k() {
  for (int w = kMaxWords; w > 0; --w) {
    if (smem_bytes(w, ring_depth(w)) <= static_cast<size_t>(kMaxSmem))
      return w * kStripe;
  }
  return 0;
}

extern "C" int nms_sweep_launch(const float* boxes, const uint8_t* valid,
                                uint8_t* keep, int g, int k,
                                float iou_thresh, int plus_one,
                                void* stream) {
  if (g <= 0 || k <= 0) return 0;
  if (k > nms_sweep_max_k()) return static_cast<int>(cudaErrorInvalidValue);
  static bool carveout_set = false;
  if (!carveout_set) {
    // Several groups share an SM only if shared memory is carved out for it.
    const void* kernels[] = {(const void*)nms_sweep_kernel<false>,
                             (const void*)nms_sweep_kernel<true>};
    for (const void* fn : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    carveout_set = true;
  }
  const auto kernel =
      plus_one ? nms_sweep_kernel<true> : nms_sweep_kernel<false>;
  const int words = (k + kStripe - 1) / kStripe;
  const int depth = ring_depth(words);
  const size_t smem = smem_bytes(words, depth);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(boxes), valid, keep, k, depth,
      iou_thresh);
  return static_cast<int>(cudaGetLastError());
}
