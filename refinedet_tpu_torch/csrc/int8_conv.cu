// The int8 path's two kernels for Hopper (sm_90a): the int8 convolution and
// the activation quantize in front of it.
//
// 1. The int8 convolution. Replaces XLA's int8 x int8 -> int32
// conv_general_dilated inside refinedet_tpu/models/layers.py:QuantConv
// (lines 83-89), which has no Pallas original: torch has no int8
// convolution on the card. An implicit GEMM over NHWC activations with
//   M = B * Ho * Wo (output pixels), N = O (output channels),
//   K = kh * kw * C (taps times input channels, in that order),
// and no im2col copy in device memory.
//
//  * Tensor cores: wgmma.mma_async m64nNk32 s32.s8.s8, both operands in
//    shared memory, K-major (the only layout s8 wgmma takes; NHWC rows and
//    the weight [O, kh, kw, C] are K-major already). Two consumer
//    warpgroups share a 128-row M tile, 64 rows each; N is 256, 128 or 64
//    (the largest that divides O). The int32 sums stay in registers.
//  * Loads: TMA (cp.async.bulk.tensor) for both operands, issued by one
//    thread of a producer warpgroup (setmaxnreg gives its registers to the
//    consumers), into a ring of stages with a full and an empty mbarrier
//    each. A K step is BK = 128, 64 or 32 bytes of channels inside one tap
//    (the largest that divides C), with the swizzle of the same width in
//    the tensor map and the wgmma descriptors.
//      - B: a 2-D tiled map over the weight [O, K].
//      - A: a 4-D tiled map over the NHWC activation. An M tile is a box of
//        bw x bh x bb output pixels (bw * bh * bb <= 128, e.g. 5 x 5 x 5
//        whole images at the 5 x 5 level), and a K step loads the box at
//        input coordinates shifted by the tap, (r * d - p, s * d - p).
//        Padding is TMA's zero fill out of bounds, exact under symmetric
//        quantization (no zero point). Stride 2 reads one of four maps
//        over the parity planes of the input (base shifted by the plane,
//        element strides doubled), so every tap is a dense box there too.
//  * Grid: persistent, one block an SM at most, walking units of (M tile,
//    N tile, K split); the producer runs ahead into the next unit while
//    the consumers store the last one. Where the tiles alone cannot fill
//    the card (the 5 x 5 and 10 x 10 levels, extra_conv2), K is split:
//    each split writes its int32 partial sums into a workspace the
//    wrapper allocates, and a second kernel adds them and applies the
//    epilogue. int32 sums are exact in any order (|sum| <= 127^2 * 9216 <
//    2^31), so the result is bitwise the unsplit one. The tile plan (box,
//    N tile, BK, splits, grid, stages) is computed in Python
//    (ops/int8_conv.py:plan) and handed to the launch.
//  * Epilogue in registers: out = float(acc) * w_scale[o] + bias[o],
//    rounded at each step (__fmul_rn, __fadd_rn: no FMA contraction), then
//    __float2bfloat16_rn or float32, or the raw int32 sums (a check mode):
//    the plain version's order of operations (ops/int8_conv.py), so the
//    two agree bit for bit. A tile row maps to (b, oh, ow) through the box;
//    rows outside the output are masked.
//
// What bounds it on this card: operations. At RefineDet320, batch 32, the
// 26 quantized convs are ~2.0 T int8 ops, ~1 ms at 1979 TOPS, against
// ~0.2 GB moved (PERF.md holds the per-shape times).
//
// 2. The activation quantize. Replaces the quantize expression JAX leaves
// to XLA's fusion in QuantConv (refinedet_tpu/models/layers.py:79-80):
//   xq = clip(round_half_even(f32(x) * (1 / in_scale[c])), -127, 127)
// over an NHWC bf16 or float32 tensor, to int8. One pass: 16-byte vector
// loads (8 bf16 or 4 float32), 8- or 4-byte int8 stores, a grid-stride
// loop whose stride is a multiple of C, so each thread's channels, and
// their 1 / in_scale (IEEE division, __fdiv_rn, once a thread), stay in
// registers. Then __fmul_rn and cvt.rni.s32 (round half to even,
// saturating), clamped to [-127, 127]: bitwise the plain version for every
// finite value and for +-inf (+-127). NaN gives 0 here; the plain
// version's float-to-int8 cast of NaN is undefined in C++ and is not
// compared. Bound by bytes: (2 or 4) + 1 a element.
//
// C interface (loaded with ctypes by ops/int8_conv.py):
//   int int8_conv_launch(const int8_t* x /*[B,H,W,C]*/,
//                        const int8_t* w /*[O,kh,kw,C]*/,
//                        const float* w_scale /*[O]*/,
//                        const float* bias /*[O]*/, void* out /*[B,Ho,Wo,O]*/,
//                        int32_t* ws /*[splits,B,Ho,Wo,O] or null*/,
//                        int b, int h, int w, int c, int o, int k,
//                        int stride, int pad, int dil, int ho, int wo,
//                        int out_kind /*0 f32, 1 bf16, 2 int32 sums*/,
//                        int bk, int bn, int bw, int bh, int bb,
//                        int splits, int grid, int stages, void* stream);
//   int int8_quantize_launch(const void* x /*[B,H,W,C] bf16 or f32*/,
//                            const float* in_scale /*[C]*/,
//                            int8_t* out /*[B,H,W,C]*/, long long n, int c,
//                            int is_bf16, void* stream);
// Each returns cudaGetLastError() after its launches (0 on success),
// cudaErrorInvalidValue for a shape or plan it does not take, or 1000 plus
// the CUDA driver API's CUresult when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels (rows) an M tile
constexpr int kConsumers = 2;     // warpgroups running wgmma, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kMaxStages = 8;
constexpr int kMaxPlanes = 4;     // stride 2: four parity planes
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Maps {
  CUtensorMap a[kMaxPlanes];  // the activation, one map a stride phase
  CUtensorMap b;              // the weight [O, K]
};

struct Geom {
  int b, ho, wo, o;     // the output
  int kw, c, stride, pad, dil;
  int bw, bh, bb;       // an M tile: a box of output pixels
  int tw, th;           // M tiles along W and H
  int n_tiles, splits, ksteps, units, stages;
  long long mo;         // B * Ho * Wo * O: one split's workspace slice
};

struct Unit {
  int b0, oh0, ow0, n0, k0, k1, split;
};

// Unit u -> its tile and K range: N tile fastest, then the split, then the
// M tile (W fastest, then H, then the batch). ops/int8_conv.py:Plan.unit
// is the same decode.
__device__ __forceinline__ Unit decode(int u, const Geom& g, int bn) {
  Unit t;
  const int nt = u % g.n_tiles;
  const int r = u / g.n_tiles;
  t.split = r % g.splits;
  const int mt = r / g.splits;
  const int tw = mt % g.tw;
  const int q = mt / g.tw;
  t.ow0 = tw * g.bw;
  t.oh0 = (q % g.th) * g.bh;
  t.b0 = (q / g.th) * g.bb;
  t.n0 = nt * bn;
  t.k0 = static_cast<int>(static_cast<long long>(t.split) * g.ksteps /
                          g.splits);
  t.k1 = static_cast<int>(static_cast<long long>(t.split + 1) * g.ksteps /
                          g.splits);
  return t;
}

__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
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

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A shared-memory matrix descriptor for a K-major tile whose rows are BK
// bytes, swizzled at BK bytes (TMA's swizzle of the same width): start
// address >> 4, leading byte offset 1 (unused for swizzled K-major), stride
// byte offset = 8 rows, the swizzle mode in bits 62-63.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t mode = BK == 128 ? 1 : BK == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>((8 * BK) >> 4) << 32 | mode << 62;
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

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma.mma_async m64nNk32, s32 += s8 x s8, A and B from shared memory;
// scale_d = 0 overwrites the accumulators instead of adding to them.
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n64(d, a, b, scale_d);
}

__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// Two neighbouring output channels `col`, `col + 1` of one pixel at `at`.
__device__ __forceinline__ void store_pair(void* out, long long at, int kind,
                                           int s0, int s1,
                                           const float* w_scale,
                                           const float* bias, int col) {
  if (kind == 2) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + at) = make_int2(s0, s1);
    return;
  }
  const float v0 = epilogue(s0, w_scale[col], bias[col]);
  const float v1 = epilogue(s1, w_scale[col + 1], bias[col + 1]);
  if (kind == 1) {
    __nv_bfloat162 pair;
    pair.x = __float2bfloat16_rn(v0);
    pair.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       at) = pair;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
        make_float2(v0, v1);
  }
}

// kind: 0 float32, 1 bfloat16, 2 the int32 sums; with splits > 1 `out` is
// the workspace and every split stores its int32 partial sums (kind 2) in
// its own slice.
template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ Maps maps,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int kind, Geom g) {
  constexpr int kABytes = kBM * BK;
  constexpr int kBBytes = BN * BK;
  constexpr int kStageBytes = kABytes + kBBytes;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned stages: the swizzle repeats every 8 rows of 128 B.
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer: one thread keeps the ring full.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * 128) {
      const int planes = g.stride * g.stride;
      for (int i = 0; i < planes; ++i) prefetch_map(&maps.a[i]);
      prefetch_map(&maps.b);
      const uint32_t a_bytes = g.bw * g.bh * g.bb * BK;
      const int cchunks = g.c / BK;
      int it = 0;
      for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
        const Unit t = decode(u, g, BN);
        for (int ks = t.k0; ks < t.k1; ++ks, ++it) {
          const int stage = it % g.stages;
          if (it >= g.stages)
            mbar_wait(&empty[stage], ((it / g.stages) & 1) ^ 1);
          uint8_t* sa = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], a_bytes + kBBytes);
          const int tap = ks / cchunks;
          const int c0 = (ks - tap * cchunks) * BK;
          const int r = tap / g.kw;
          const int s = tap - r * g.kw;
          const int rr = r * g.dil - g.pad;
          const int ss = s * g.dil - g.pad;
          const int qh = floor_div(rr, g.stride);
          const int qw = floor_div(ss, g.stride);
          const int plane =
              (rr - qh * g.stride) * g.stride + (ss - qw * g.stride);
          tma_load_4d(sa, &maps.a[plane], c0, t.ow0 + qw, t.oh0 + qh, t.b0,
                      &full[stage]);
          tma_load_2d(sa + kABytes, &maps.b, ks * BK, t.n0, &full[stage]);
        }
      }
    }
  } else {
    // The consumers: wgmma on the stages that have landed, then the
    // epilogue of the unit while the producer loads the next one.
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int rows = g.bw * g.bh * g.bb;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t base = smem_addr(smem);
    int it = 0;
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit t = decode(u, g, BN);
      int held = -1;  // the stage whose wgmma group may still be running
      for (int ks = t.k0; ks < t.k1; ++ks, ++it) {
        const int stage = it % g.stages;
        mbar_wait(&full[stage], (it / g.stages) & 1);
        const uint32_t sa = base + stage * kStageBytes;
        const uint64_t da = smem_desc<BK>(sa + wg * 64 * BK);
        const uint64_t db = smem_desc<BK>(sa + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes: +2 in the address
          wgmma_k32<BN>(acc, da + 2 * kk, db + 2 * kk,
                        ks > t.k0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group has finished
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
      }
      wgmma_wait<0>();
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

      void* dst = out;
      int dkind = kind;
      long long slice = 0;
      if (g.splits > 1) {
        dkind = 2;
        slice = static_cast<long long>(t.split) * g.mo;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wg * 64 + warp * 16 + (lane >> 2) + half * 8;
        if (row >= rows) continue;
        const int ww = row % g.bw;
        const int rest = row / g.bw;
        const int b = t.b0 + rest / g.bh;
        const int oh = t.oh0 + rest % g.bh;
        const int ow = t.ow0 + ww;
        if (b >= g.b || oh >= g.ho || ow >= g.wo) continue;
        const int col = t.n0 + 2 * (lane & 3);
        const long long at =
            slice +
            ((static_cast<long long>(b) * g.ho + oh) * g.wo + ow) * g.o + col;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          store_pair(dst, at + 8 * j, dkind, acc[4 * j + 2 * half],
                     acc[4 * j + 2 * half + 1], w_scale, bias, col + 8 * j);
      }
    }
  }
}

// Split K: the sum of the splits' partial sums, then the epilogue; four
// channels a thread.
__global__ void __launch_bounds__(256)
    int8_conv_reduce(const int* __restrict__ ws, int splits, long long mo,
                     int o, const float* __restrict__ w_scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int kind) {
  const long long n4 = mo / 4;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n4; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    int4 s = reinterpret_cast<const int4*>(ws)[v];
    for (int k = 1; k < splits; ++k) {
      const int4 p = reinterpret_cast<const int4*>(ws + k * mo)[v];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int col = static_cast<int>((v * 4) % o);
    store_pair(out, v * 4, kind, s.x, s.y, w_scale, bias, col);
    store_pair(out, v * 4 + 2, kind, s.z, s.w, w_scale, bias, col + 2);
  }
}

// ---- the activation quantize ----------------------------------------------

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (V == 8) {  // 8 bf16
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __low2float(h[i]);
      f[2 * i + 1] = __high2float(h[i]);
    }
  } else if constexpr (V == 4) {  // 4 float32
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else if constexpr (sizeof(T) == 2) {
    f[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    f[0] = *reinterpret_cast<const float*>(p);
  }
}

__device__ __forceinline__ uint32_t quantize(float x, float inv) {
  // cvt.rni.s32.f32: round half to even, saturating (+-inf to INT_MAX /
  // INT_MIN, NaN to 0); then the clamp.
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xFFu;
}

// Each thread's vectors sit at one channel offset: the launch makes the
// grid's stride (threads x V) a multiple of C.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    int8_quantize_kernel(const T* __restrict__ x,
                         const float* __restrict__ in_scale,
                         int8_t* __restrict__ out, long long nvec, int c) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const int c0 = static_cast<int>((v * V) % c);
  float inv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) inv[i] = __fdiv_rn(1.0f, in_scale[c0 + i]);
  for (; v < nvec; v += step) {
    float f[V];
    load_vec<T, V>(x + v * V, f);
    if constexpr (V == 8) {
      uint2 q;
      q.x = quantize(f[0], inv[0]) | quantize(f[1], inv[1]) << 8 |
            quantize(f[2], inv[2]) << 16 | quantize(f[3], inv[3]) << 24;
      q.y = quantize(f[4], inv[4]) | quantize(f[5], inv[5]) << 8 |
            quantize(f[6], inv[6]) << 16 | quantize(f[7], inv[7]) << 24;
      reinterpret_cast<uint2*>(out)[v] = q;
    } else if constexpr (V == 4) {
      reinterpret_cast<uint32_t*>(out)[v] =
          quantize(f[0], inv[0]) | quantize(f[1], inv[1]) << 8 |
          quantize(f[2], inv[2]) << 16 | quantize(f[3], inv[3]) << 24;
    } else {
      out[v] = static_cast<int8_t>(quantize(f[0], inv[0]));
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, through the runtime (no
// -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

CUtensorMapSwizzle swizzle(int bk) {
  return bk == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int BN, int BK>
int launch(const Maps& maps, const float* w_scale, const float* bias,
           void* dst, int kind, const Geom& g, int grid, cudaStream_t st) {
  static_assert(BN % 64 == 0 && BN <= 256 && BK % 32 == 0 && BK <= 128, "");
  const size_t smem = static_cast<size_t>(g.stages) * (kBM + BN) * BK +
                      1024 + 2 * kMaxStages * sizeof(uint64_t);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // once an instantiation, before any capture into a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int8_conv_kernel<BN, BK><<<grid, kThreads, smem, st>>>(maps, w_scale, bias,
                                                         dst, kind, g);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bk(int bk, const Maps& maps, const float* w_scale,
              const float* bias, void* dst, int kind, const Geom& g, int grid,
              cudaStream_t st) {
  if (bk == 128) return launch<BN, 128>(maps, w_scale, bias, dst, kind, g,
                                        grid, st);
  if (bk == 64) return launch<BN, 64>(maps, w_scale, bias, dst, kind, g,
                                      grid, st);
  return launch<BN, 32>(maps, w_scale, bias, dst, kind, g, grid, st);
}

}  // namespace

extern "C" int int8_conv_launch(const int8_t* x, const int8_t* w,
                                const float* w_scale, const float* bias,
                                void* out, int32_t* ws, int b, int h, int wd,
                                int c, int o, int k, int stride, int pad,
                                int dil, int ho, int wo, int out_kind, int bk,
                                int bn, int bw, int bh, int bb, int splits,
                                int grid, int stages, void* stream) {
  const bool bad =
      b <= 0 || h <= 0 || wd <= 0 || ho <= 0 || wo <= 0 || k <= 0 ||
      (bk != 32 && bk != 64 && bk != 128) || c <= 0 || c % bk ||
      (bn != 64 && bn != 128 && bn != 256) || o <= 0 || o % bn ||
      (stride != 1 && stride != 2) || h < stride || wd < stride || pad < 0 ||
      dil <= 0 || out_kind < 0 || out_kind > 2 || bw <= 0 || bh <= 0 ||
      bb <= 0 || bw * bh * bb > kBM || stages < 1 || stages > kMaxStages ||
      splits < 1 || grid < 1 || (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.b = b;
  g.ho = ho;
  g.wo = wo;
  g.o = o;
  g.kw = k;
  g.c = c;
  g.stride = stride;
  g.pad = pad;
  g.dil = dil;
  g.bw = bw;
  g.bh = bh;
  g.bb = bb;
  g.tw = (wo + bw - 1) / bw;
  g.th = (ho + bh - 1) / bh;
  const long long tb = (b + bb - 1) / bb;
  g.n_tiles = o / bn;
  g.splits = splits;
  g.ksteps = k * k * (c / bk);
  g.stages = stages;
  g.mo = static_cast<long long>(b) * ho * wo * o;
  const long long units =
      static_cast<long long>(g.tw) * g.th * tb * g.n_tiles * splits;
  if (splits > g.ksteps || units > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  g.units = static_cast<int>(units);
  if (grid > g.units) grid = g.units;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  for (int ph = 0; ph < stride; ++ph)
    for (int pw = 0; pw < stride; ++pw) {
      // The plane of input pixels (stride * i + ph, stride * j + pw).
      const cuuint64_t dims[4] = {
          static_cast<cuuint64_t>(c),
          static_cast<cuuint64_t>((wd - pw + stride - 1) / stride),
          static_cast<cuuint64_t>((h - ph + stride - 1) / stride),
          static_cast<cuuint64_t>(b)};
      const cuuint64_t strides[3] = {
          static_cast<cuuint64_t>(stride) * c,
          static_cast<cuuint64_t>(stride) * wd * c,
          static_cast<cuuint64_t>(h) * wd * c};
      const cuuint32_t box[4] = {static_cast<cuuint32_t>(bk),
                                 static_cast<cuuint32_t>(bw),
                                 static_cast<cuuint32_t>(bh),
                                 static_cast<cuuint32_t>(bb)};
      const int8_t* origin = x + (static_cast<long long>(ph) * wd + pw) * c;
      const CUresult r = encode(
          &maps.a[ph * stride + pw], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
          const_cast<int8_t*>(origin), dims, strides, box, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(bk),
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
    }
  {
    const long long kdim = static_cast<long long>(k) * k * c;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kdim),
                                static_cast<cuuint64_t>(o)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kdim)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(bk),
                               static_cast<cuuint32_t>(bn)};
    const CUresult r = encode(
        &maps.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w),
        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(bk),
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  }

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* dst = splits > 1 ? static_cast<void*>(ws) : out;
  int err;
  if (bn == 256)
    err = launch_bk<256>(bk, maps, w_scale, bias, dst, out_kind, g, grid, st);
  else if (bn == 128)
    err = launch_bk<128>(bk, maps, w_scale, bias, dst, out_kind, g, grid, st);
  else
    err = launch_bk<64>(bk, maps, w_scale, bias, dst, out_kind, g, grid, st);
  if (err || splits == 1) return err;
  const long long n4 = g.mo / 4;
  const long long want = (n4 + 255) / 256;
  const int cap = sm_count() * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  int8_conv_reduce<<<blocks, 256, 0, st>>>(ws, splits, g.mo, o, w_scale, bias,
                                           out, out_kind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_quantize_launch(const void* x, const float* in_scale,
                                    int8_t* out, long long n, int c,
                                    int is_bf16, void* stream) {
  if (n < 0 || c <= 0 || n % c) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const uintptr_t px = reinterpret_cast<uintptr_t>(x);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  const int wide = is_bf16 ? 8 : 4;  // 16 bytes of input a vector
  const int v = c % wide == 0 && px % 16 == 0 && po % wide == 0 ? wide : 1;
  const long long nvec = n / v;
  // a grid stride (blocks x 256 x v) that is a multiple of C
  int a = c, r = 256 * v;
  while (r) {
    const int t = a % r;
    a = r;
    r = t;
  }
  const long long unit = c / a;  // blocks a multiple of this
  long long blocks = (nvec + 255) / 256;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16 && v == 8)
    int8_quantize_kernel<__nv_bfloat16, 8><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), in_scale, out, nvec, c);
  else if (is_bf16)
    int8_quantize_kernel<__nv_bfloat16, 1><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), in_scale, out, nvec, c);
  else if (v == 4)
    int8_quantize_kernel<float, 4><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), in_scale, out, nvec, c);
  else
    int8_quantize_kernel<float, 1><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), in_scale, out, nvec, c);
  return static_cast<int>(cudaGetLastError());
}
