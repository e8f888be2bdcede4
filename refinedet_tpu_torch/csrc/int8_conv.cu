// The int8 convolution of the quantized serving path, for Hopper (sm_90a).
//
// Replaces XLA's int8 x int8 -> int32 conv_general_dilated inside
// refinedet_tpu/models/layers.py:QuantConv (lines 83-89), which has no Pallas
// original: torch has no int8 convolution on the card. It is a tiled
// implicit GEMM over NHWC activations, with
//   M = B * Ho * Wo (output pixels), N = O (output channels),
//   K = kh * kw * C (taps times input channels, in that order),
// the A tile gathered straight from the activation with the padding, stride
// and dilation applied (no im2col copy in device memory), the B tile from the
// weight [O, kh, kw, C], whose rows are K-contiguous.
//
// Block tile 128 (M) x 64 (N) x 32 (K), four warps of 64 x 32 each. Since C is
// a multiple of 32, one K step of 32 lies inside one tap: each output pixel
// reads 32 contiguous bytes (two 16-byte cp.async, zero-filled where the tap
// falls in the padding or the pixel past M), each output channel 32 bytes of
// its weight row. Three stages of cp.async keep the next tiles in flight
// while the tensor cores multiply the current one with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, fragments read from shared memory
// with 32-bit loads; rows are padded to 48 bytes so those loads hit 32
// distinct banks. The sum is int32 and exact: |sum| <= 127^2 * 9216 < 2^31.
//
// Epilogue in registers: out = float(acc) * w_scale[o] + bias[o], rounded at
// each step (__fmul_rn, __fadd_rn: no FMA contraction), then
// __float2bfloat16_rn or float32, or the raw int32 sums (a check mode). This
// is the plain version's order of operations (ops/int8_conv.py), so the two
// agree bit for bit.
//
// What bounds it on this card: operations. At RefineDet320, batch 32, the
// 26 quantized convs are ~2.0 T int8 ops, a bound of ~1 ms at 1979 TOPS,
// against ~0.2 GB moved. The design is the simple, right one: mma.sync
// (wgmma alone reaches the dense rate), fragment loads that cost a
// shared-memory read per MMA operand, no TMA, and too few blocks to fill
// the card at the small TCB levels, so it runs well below that bound;
// PERF.md holds its times.
//
// C interface (loaded with ctypes by ops/int8_conv.py):
//   int int8_conv_launch(const int8_t* x /*[B,H,W,C]*/,
//                        const int8_t* w /*[O,kh,kw,C]*/,
//                        const float* w_scale /*[O]*/,
//                        const float* bias /*[O]*/, void* out /*[B,Ho,Wo,O]*/,
//                        int b, int h, int w, int c, int o, int kh, int kw,
//                        int stride, int pad, int dil, int ho, int wo,
//                        int out_kind /*0 f32, 1 bf16, 2 int32 sums*/,
//                        void* stream);
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels a block
constexpr int kBN = 64;      // output channels a block
constexpr int kBK = 32;      // K a step (bytes of int8)
constexpr int kStages = 3;   // cp.async pipeline depth
constexpr int kThreads = 128;
constexpr int kRow = 48;     // shared-memory bytes a tile row (32 + 16 pad)
constexpr int kAPieces = kBM * 2 / kThreads;  // 16-byte copies a thread, A

struct Geom {
  int h, w, c, o, kw, stride, pad, dil, ho, wo;
  long long m;  // B * Ho * Wo
  int ksteps;   // kh * kw * C / 32
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = fill ? 16 : 0;  // 0: write 16 zero bytes, read none
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// kOut: 0 float32, 1 bfloat16, 2 the int32 sums.
template <int kOut>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     Geom g) {
  __shared__ __align__(16) int8_t sa[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sb[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long kdim = static_cast<long long>(g.ksteps) * kBK;
  const int cchunks = g.c / kBK;

  // Each thread copies kAPieces 16-byte halves of A rows (one output pixel a
  // row) and one half of a B row (one output channel a row) per K step. The
  // pixel of each A row is fixed over the K loop.
  int a_row[kAPieces], a_half[kAPieces], a_ih0[kAPieces], a_iw0[kAPieces];
  long long a_base[kAPieces];
  bool a_live[kAPieces];
#pragma unroll
  for (int i = 0; i < kAPieces; ++i) {
    const int p = tid + i * kThreads;
    a_row[i] = p >> 1;
    a_half[i] = p & 1;
    const long long m = m0 + a_row[i];
    a_live[i] = m < g.m;
    const long long mm = a_live[i] ? m : 0;
    const long long hw = static_cast<long long>(g.ho) * g.wo;
    const long long b = mm / hw;
    const int rem = static_cast<int>(mm - b * hw);
    const int oh = rem / g.wo;
    const int ow = rem - oh * g.wo;
    a_ih0[i] = oh * g.stride - g.pad;
    a_iw0[i] = ow * g.stride - g.pad;
    a_base[i] = b * g.h * g.w * g.c + a_half[i] * 16;
  }
  const int b_row = tid >> 1;
  const int b_half = tid & 1;
  const int8_t* b_src = w + static_cast<long long>(n0 + b_row) * kdim +
                        b_half * 16;

  auto load_stage = [&](int stage, int kstep) {
    const int tap = kstep / cchunks;
    const int c0 = (kstep - tap * cchunks) * kBK;
    const int r = tap / g.kw;
    const int s = tap - r * g.kw;
#pragma unroll
    for (int i = 0; i < kAPieces; ++i) {
      const int ih = a_ih0[i] + r * g.dil;
      const int iw = a_iw0[i] + s * g.dil;
      const bool in = a_live[i] && ih >= 0 && ih < g.h && iw >= 0 &&
                      iw < g.w;
      const int8_t* src =
          in ? x + a_base[i] + (static_cast<long long>(ih) * g.w + iw) * g.c +
                   c0
             : x;
      cp_async16(&sa[stage][a_row[i] * kRow + a_half[i] * 16], src, in);
    }
    cp_async16(&sb[stage][b_row * kRow + b_half * 16],
               b_src + static_cast<long long>(kstep) * kBK, true);
  };

  const int gid = lane >> 2;  // the MMA fragments' row (A) / column (B)
  const int tig = lane & 3;   // the lane's 4-byte slice of a K step
  const int wm = (warp >> 1) * 64;
  const int wn = (warp & 1) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g.ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < g.ksteps; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step k landed; step k-1's stage is free
    const int next = k + kStages - 1;
    if (next < g.ksteps) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* as = sa[k % kStages];
    const int8_t* bs = sb[k % kStages];
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* r0 = as + (wm + i * 16 + gid) * kRow + tig * 4;
      af[i][0] = lds32(r0);
      af[i][1] = lds32(r0 + 8 * kRow);
      af[i][2] = lds32(r0 + 16);
      af[i][3] = lds32(r0 + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* c0 = bs + (wn + j * 8 + gid) * kRow + tig * 4;
      bf[j][0] = lds32(c0);
      bf[j][1] = lds32(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // Accumulator fragment: e = 0, 1 at row gid, e = 2, 3 at row gid + 8;
  // columns tig * 2 and tig * 2 + 1.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = m0 + wm + i * 16 + gid + hf * 8;
      if (m >= g.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
        const long long at = m * g.o + col;
        const int s0 = acc[i][j][hf * 2];
        const int s1 = acc[i][j][hf * 2 + 1];
        if (kOut == 2) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + at) =
              make_int2(s0, s1);
          continue;
        }
        const float v0 = __fadd_rn(
            __fmul_rn(__int2float_rn(s0), w_scale[col]), bias[col]);
        const float v1 = __fadd_rn(
            __fmul_rn(__int2float_rn(s1), w_scale[col + 1]), bias[col + 1]);
        if (kOut == 1) {
          __nv_bfloat162 pair;
          pair.x = __float2bfloat16_rn(v0);
          pair.y = __float2bfloat16_rn(v1);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + at) = pair;
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

}  // namespace

extern "C" int int8_conv_launch(const int8_t* x, const int8_t* w,
                                const float* w_scale, const float* bias,
                                void* out, int b, int h, int wd, int c, int o,
                                int kh, int kw, int stride, int pad, int dil,
                                int ho, int wo, int out_kind, void* stream) {
  if (c <= 0 || c % kBK || o <= 0 || o % kBN || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || pad < 0 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.h = h;
  g.w = wd;
  g.c = c;
  g.o = o;
  g.kw = kw;
  g.stride = stride;
  g.pad = pad;
  g.dil = dil;
  g.ho = ho;
  g.wo = wo;
  g.m = static_cast<long long>(b) * ho * wo;
  g.ksteps = kh * kw * (c / kBK);
  if (g.m == 0) return 0;
  const long long blocks = (g.m + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), o / kBN);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    int8_conv_kernel<0><<<grid, kThreads, 0, st>>>(x, w, w_scale, bias, out,
                                                   g);
  else if (out_kind == 1)
    int8_conv_kernel<1><<<grid, kThreads, 0, st>>>(x, w, w_scale, bias, out,
                                                   g);
  else
    int8_conv_kernel<2><<<grid, kThreads, 0, st>>>(x, w, w_scale, bias, out,
                                                   g);
  return static_cast<int>(cudaGetLastError());
}
