// The convolution epilogue for Hopper (sm_90a): the bias add and the ReLU
// after cuDNN's convolution, as one pass in place over its output.
//
// aten's _convolution runs cuDNN without the bias, then
// output.add_(bias.view(1, C, 1, 1)); the ReLU after it is a third pass.
// The broadcast bias keeps that add off TensorIterator's vectorized path.
// This kernel replaces both passes on a conv's fresh output y [N, C, H, W]:
//   r = round_to_nearest_even(float(y) + float(bias[c])) in y's dtype,
//   y = r <= 0 ? +0 : r            (NaN passes through)
// which is bitwise aten's add_ then relu_: both add in float32 and round
// once (__float2bfloat16_rn, the cvt c10::BFloat16 uses on sm_80 and up),
// and clamp_min(0) keeps NaN.
//
//  * Layout: channels-last (NHWC memory) or NCHW-contiguous, a flag from
//    the wrapper, which reads it from the tensor's strides.
//  * Loads and stores: 16-byte vectors (8 bf16 or 4 float32); C is a
//    multiple of 8 and the base 16-byte aligned (the wrapper checks both).
//  * Grid: one vector a thread, blocks of 256 covering the tensor, as
//    aten's vectorized elementwise kernels run; a grid-stride loop takes
//    over only past 2^31 - 1 blocks. Measured on an H100 over the
//    benchmark cells' outputs: 87-89% of the bytes bound, aten's relu_'s
//    rate on the same tensors; a persistent grid of resident blocks, each
//    striding with 1-8 vectors in flight, reached 83-85% (PERF.md).
//  * Channels-last: the grid's stride (blocks x 256 x V) is a multiple of
//    C, so a thread's V channels are fixed and their bias, converted to
//    float32 once, stays in registers.
//  * NCHW: each vector walks its elements' (channel, position in the
//    plane) from one division, the bias read per element (cached).
//
// What bounds it: bytes, each element read once and written once. It
// allocates nothing, never synchronizes and launches on the given stream,
// so a CUDA graph can capture it.
//
// C interface (loaded with ctypes by ops/conv_epilogue.py):
//   int conv_bias_relu_launch(void* y /*[N,C,H,W] bf16 or f32, in place*/,
//                             const void* bias /*[C], y's dtype*/,
//                             long long n /*elements*/, int c,
//                             long long hw /*H*W*/,
//                             int channels_last, int is_bf16, void* stream);
// returns cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffffLL;

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // float(y) + b rounded once to bf16, then the ReLU.
  __device__ static __nv_bfloat16 apply(__nv_bfloat16 y, float b) {
    const __nv_bfloat16 r =
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
    return __bfloat162float(r) <= 0.0f ? __float2bfloat16_rn(0.0f) : r;
  }
};

template <>
struct Traits<float> {
  static constexpr int V = 4;
  __device__ static float to_float(float x) { return x; }
  __device__ static float apply(float y, float b) {
    const float r = __fadd_rn(y, b);
    return r <= 0.0f ? 0.0f : r;
  }
};

// The epilogue on one 16-byte vector of T whose element i has bias b[i].
template <typename T>
__device__ __forceinline__ uint4 apply_vec(uint4 raw, const float* b) {
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Traits<T>::V; ++i) e[i] = Traits<T>::apply(e[i], b[i]);
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_bias_relu_kernel(T* __restrict__ y, const T* __restrict__ bias,
                          long long nvec, int c) {
  constexpr int V = Traits<T>::V;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= nvec) return;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const int c0 = static_cast<int>((v * V) % c);
  float b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) b[i] = Traits<T>::to_float(bias[c0 + i]);
  uint4* p = reinterpret_cast<uint4*>(y);
  for (; v < nvec; v += step) p[v] = apply_vec<T>(p[v], b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_bias_relu_kernel_nchw(T* __restrict__ y, const T* __restrict__ bias,
                               long long nvec, int c, long long hw) {
  constexpr int V = Traits<T>::V;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  uint4* p = reinterpret_cast<uint4*>(y);
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       v < nvec; v += step) {
    const long long i = v * V;
    const long long plane = i / hw;
    long long r = i - plane * hw;
    int ch = static_cast<int>(plane % c);
    float b[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      b[e] = Traits<T>::to_float(__ldg(bias + ch));
      if (++r == hw) {
        r = 0;
        ch = ch + 1 == c ? 0 : ch + 1;
      }
    }
    p[v] = apply_vec<T>(p[v], b);
  }
}

template <typename T>
int launch(void* y, const void* bias, long long n, int c, long long hw,
           int channels_last, cudaStream_t st) {
  constexpr int V = Traits<T>::V;
  const long long nvec = n / V;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  T* py = static_cast<T*>(y);
  const T* pb = static_cast<const T*>(bias);
  if (channels_last) {
    // a grid stride (blocks x 256 x V) that is a multiple of C
    int a = c, r = kThreads * V;
    while (r) {
      const int t = a % r;
      a = r;
      r = t;
    }
    const long long unit = c / a;  // blocks a multiple of this
    blocks = (blocks + unit - 1) / unit * unit;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks / unit * unit;
    conv_bias_relu_kernel<T>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(py, pb, nvec, c);
  } else {
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    conv_bias_relu_kernel_nchw<T>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(py, pb, nvec, c,
                                                             hw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_bias_relu_launch(void* y, const void* bias, long long n,
                                     int c, long long hw, int channels_last,
                                     int is_bf16, void* stream) {
  if (n < 0 || c <= 0 || c % 8 || hw <= 0 || n % (c * hw) ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(y, bias, n, c, hw, channels_last, st)
                 : launch<float>(y, bias, n, c, hw, channels_last, st);
}
