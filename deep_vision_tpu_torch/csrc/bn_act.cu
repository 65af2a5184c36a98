// Fused BatchNorm apply + ReLU (+ residual add), forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_kernel` and `_kernel_res` launched by
// `_pallas_apply` (deep_vision_tpu/ops/pallas/bn_act.py:78 and :89, calls at
// :134 and :125), and gives their lax backward `_bwd_common` (:158) a kernel:
//
//   forward   y = act(x * scale + bias [+ r])        f32 math, io dtype out
//   backward  g' = g * [y > 0]   (g when act is None; y is the saved output)
//             dx = g' * scale    (io dtype)       dres = g'   (io dtype)
//             dscale = sum g' * x   dbias = sum g'   (f32, per channel)
//
// The forward evaluates the reference's operations in its order: x * a + b,
// then + r, then the ReLU, then one rounding to the io dtype
// (__float2bfloat16_rn for bf16). The build uses --fmad=false, so x * a + b
// does not contract to an FMA, and the forward, dx and dres are bit for bit
// equal to the plain PyTorch version. The ReLU is `v < 0 ? 0 : v`, which keeps
// a NaN, as jnp.maximum does. The channel sums are per-thread partials,
// reduced by a second kernel in a fixed order: no float atomics, so they are
// deterministic, and they agree with the plain version's sums to within a
// bound relative to the sum of |terms| (f32 rounding of two summation orders).
//
// Layouts, chosen by the wrapper from the strides (x, r, y, g, dx and dres
// all share x's):
//   rows    channels_last 4-D or contiguous 2-D: element i has channel i % C.
//           A thread takes the elements g, g + S, g + 2S, ... where the
//           stride S is the largest multiple of C not above the thread count,
//           so its channel, scale and bias are fixed: one modulo per thread,
//           none per element. Its channel partials go to row g / C of a
//           (S / C, C) partial matrix.
//   planes  contiguous NCHW: a block walks whole (n, c) planes of H*W
//           elements, so the channel is fixed per plane; each plane's sums
//           are reduced in the block (fixed shuffle tree) into row n of an
//           (N, C) partial matrix.
// Any C and any element count: ragged tails are bounds-checked, indices are
// 64-bit.
//
// What bounds it. Bytes: the forward reads x (and r) and writes y once per
// element, 2-3 accesses of 2 bytes in bf16, against 2-3 flops; the backward
// reads g, x and y and writes dx (and dres), 4-5 accesses against ~6 flops.
// Both are far below the H100's ~295 flops per byte, so the time is memory
// traffic. This first version loads one element per thread per access,
// unrolled four deep to keep loads in flight. A later version could load 16
// bytes per thread (8 bf16 channels), stage tiles through TMA, and fuse the
// BatchNorm statistics reduction (E[x], E[x^2]) into the same passes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kRes, bool kRelu>
__device__ __forceinline__ T fwd_one(const T* __restrict__ x,
                                     const T* __restrict__ r, int64_t i,
                                     float a, float b) {
  float v = to_f32(x[i]) * a + b;  // no FMA: built with --fmad=false
  if (kRes) v = v + to_f32(r[i]);
  if (kRelu) v = v < 0.0f ? 0.0f : v;
  return from_f32<T>(v);
}

template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
fwd_rows(const T* __restrict__ x, const T* __restrict__ r,
         const float* __restrict__ scale, const float* __restrict__ bias,
         T* __restrict__ y, int64_t n, int c, int64_t stride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;
  const int ch = static_cast<int>(t % c);
  const float a = scale[ch];
  const float b = bias[ch];
  int64_t i = t;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T out[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      out[u] = fwd_one<T, kRes, kRelu>(x, r, i + u * stride, a, b);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = out[u];
  }
  for (; i < n; i += stride) y[i] = fwd_one<T, kRes, kRelu>(x, r, i, a, b);
}

template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
fwd_planes(const T* __restrict__ x, const T* __restrict__ r,
           const float* __restrict__ scale, const float* __restrict__ bias,
           T* __restrict__ y, int64_t planes, int64_t hw, int c) {
  for (int64_t p = blockIdx.x; p < planes; p += gridDim.x) {
    const int ch = static_cast<int>(p % c);
    const float a = scale[ch];
    const float b = bias[ch];
    const int64_t base = p * hw;
    for (int64_t k = threadIdx.x; k < hw; k += kThreads)
      y[base + k] = fwd_one<T, kRes, kRelu>(x, r, base + k, a, b);
  }
}

// one element of the backward: writes dx (and dres), adds to the two sums
template <typename T, bool kRes, bool kRelu>
__device__ __forceinline__ void bwd_one(const T* __restrict__ g,
                                        const T* __restrict__ x,
                                        const T* __restrict__ y,
                                        T* __restrict__ dx,
                                        T* __restrict__ dres, int64_t i,
                                        float a, float& sgx, float& sg) {
  float gp = to_f32(g[i]);
  if (kRelu) gp = to_f32(y[i]) > 0.0f ? gp : 0.0f;
  dx[i] = from_f32<T>(gp * a);
  if (kRes) dres[i] = from_f32<T>(gp);
  sgx = __fmaf_rn(gp, to_f32(x[i]), sgx);
  sg += gp;
}

template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_rows(const T* __restrict__ g, const T* __restrict__ x,
         const T* __restrict__ y, const float* __restrict__ scale,
         T* __restrict__ dx, T* __restrict__ dres,
         float2* __restrict__ partial, int64_t n, int c, int64_t stride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;
  const float a = scale[t % c];
  float sgx = 0.0f, sg = 0.0f;
  int64_t i = t;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float gv[kUnroll], xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = to_f32(g[i + u * stride]);
      xv[u] = to_f32(x[i + u * stride]);
      yv[u] = kRelu ? to_f32(y[i + u * stride]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float gp = (!kRelu || yv[u] > 0.0f) ? gv[u] : 0.0f;
      dx[i + u * stride] = from_f32<T>(gp * a);
      if (kRes) dres[i + u * stride] = from_f32<T>(gp);
      sgx = __fmaf_rn(gp, xv[u], sgx);
      sg += gp;
    }
  }
  for (; i < n; i += stride)
    bwd_one<T, kRes, kRelu>(g, x, y, dx, dres, i, a, sgx, sg);
  partial[t] = make_float2(sgx, sg);
}

// fixed-order block sum of (sgx, sg); the result is valid in thread 0
__device__ __forceinline__ float2 block_sum(float2 v, float2* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, off);
      v.y += __shfl_down_sync(0xffffffffu, v.y, off);
    }
  }
  __syncthreads();  // warp_sums may be reused by the next plane
  return v;
}

template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_planes(const T* __restrict__ g, const T* __restrict__ x,
           const T* __restrict__ y, const float* __restrict__ scale,
           T* __restrict__ dx, T* __restrict__ dres,
           float2* __restrict__ partial, int64_t planes, int64_t hw, int c) {
  __shared__ float2 warp_sums[kThreads / 32];
  for (int64_t p = blockIdx.x; p < planes; p += gridDim.x) {
    const float a = scale[p % c];
    const int64_t base = p * hw;
    float sgx = 0.0f, sg = 0.0f;
    for (int64_t k = threadIdx.x; k < hw; k += kThreads)
      bwd_one<T, kRes, kRelu>(g, x, y, dx, dres, base + k, a, sgx, sg);
    const float2 s = block_sum(make_float2(sgx, sg), warp_sums);
    if (threadIdx.x == 0) partial[p] = s;  // plane p = row n, column c
  }
}

// dscale[c], dbias[c] = column sums of the (rows, C) partial matrix, in
// column_sum's fixed order.
__global__ void __launch_bounds__(kColumnSumCols * kColumnSumGroups)
reduce_partials(const float2* __restrict__ partial, int64_t rows, int c,
                float* __restrict__ dscale, float* __restrict__ dbias) {
  int ch;
  float2 t;
  if (column_sum(rows, c,
                 [=](int64_t j, int k) { return partial[j * c + k]; }, ch,
                 t)) {
    dscale[ch] = t.x;
    dbias[ch] = t.y;
  }
}

template <typename T, bool kRes, bool kRelu>
void launch_fwd(const void* x, const void* r, const float* scale,
                const float* bias, void* y, int64_t n, int c, int64_t hw,
                int planes_layout, int blocks, int64_t stride,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (planes_layout)
    fwd_planes<T, kRes, kRelu><<<blocks, kThreads, 0, stream>>>(
        xt, rt, scale, bias, yt, n / hw, hw, c);
  else
    fwd_rows<T, kRes, kRelu><<<blocks, kThreads, 0, stream>>>(
        xt, rt, scale, bias, yt, n, c, stride);
}

template <typename T, bool kRes, bool kRelu>
void launch_bwd(const void* g, const void* x, const void* y,
                const float* scale, void* dx, void* dres, float2* partial,
                int64_t n, int c, int64_t hw, int planes_layout, int blocks,
                int64_t stride, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* drt = static_cast<T*>(dres);
  if (planes_layout)
    bwd_planes<T, kRes, kRelu><<<blocks, kThreads, 0, stream>>>(
        gt, xt, yt, scale, dxt, drt, partial, n / hw, hw, c);
  else
    bwd_rows<T, kRes, kRelu><<<blocks, kThreads, 0, stream>>>(
        gt, xt, yt, scale, dxt, drt, partial, n, c, stride);
}

template <typename T>
void dispatch_fwd(int res, int relu, const void* x, const void* r,
                  const float* scale, const float* bias, void* y, int64_t n,
                  int c, int64_t hw, int planes_layout, int blocks,
                  int64_t stride, cudaStream_t s) {
  if (res && relu)
    launch_fwd<T, true, true>(x, r, scale, bias, y, n, c, hw, planes_layout,
                              blocks, stride, s);
  else if (res)
    launch_fwd<T, true, false>(x, r, scale, bias, y, n, c, hw, planes_layout,
                               blocks, stride, s);
  else if (relu)
    launch_fwd<T, false, true>(x, r, scale, bias, y, n, c, hw, planes_layout,
                               blocks, stride, s);
  else
    launch_fwd<T, false, false>(x, r, scale, bias, y, n, c, hw,
                                planes_layout, blocks, stride, s);
}

template <typename T>
void dispatch_bwd(int res, int relu, const void* g, const void* x,
                  const void* y, const float* scale, void* dx, void* dres,
                  float2* partial, int64_t n, int c, int64_t hw,
                  int planes_layout, int blocks, int64_t stride,
                  cudaStream_t s) {
  if (res && relu)
    launch_bwd<T, true, true>(g, x, y, scale, dx, dres, partial, n, c, hw,
                              planes_layout, blocks, stride, s);
  else if (res)
    launch_bwd<T, true, false>(g, x, y, scale, dx, dres, partial, n, c, hw,
                               planes_layout, blocks, stride, s);
  else if (relu)
    launch_bwd<T, false, true>(g, x, y, scale, dx, dres, partial, n, c, hw,
                               planes_layout, blocks, stride, s);
  else
    launch_bwd<T, false, false>(g, x, y, scale, dx, dres, partial, n, c, hw,
                                planes_layout, blocks, stride, s);
}

}  // namespace

// Threads per block of the element kernels (the wrapper sizes grids with it).
extern "C" int dvt_bn_act_threads() { return kThreads; }

// y = act(x * scale + bias [+ r]). x, r, y: n elements of dtype (0 = f32,
// 1 = bf16) in one layout (planes_layout 0: rows of c channels, `stride` a
// multiple of c no larger than blocks * threads; 1: n / hw planes of hw,
// channel = plane % c). r may be null. scale, bias: c floats. Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int dvt_bn_act_fwd(const void* x, const void* r, const void* scale,
                              const void* bias, void* y, long long n, int c,
                              long long hw, int planes_layout, int dtype,
                              int relu, int blocks, long long stride,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dispatch_fwd<__nv_bfloat16>(r != nullptr, relu, x, r, sc, bi, y, n, c, hw,
                                planes_layout, blocks, stride, s);
  else
    dispatch_fwd<float>(r != nullptr, relu, x, r, sc, bi, y, n, c, hw,
                        planes_layout, blocks, stride, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward: dx (and dres when non-null) in x's dtype and layout, and
// dscale, dbias (c floats each) through `partial`, a (partial_rows, c)
// float2 scratch: partial_rows = stride / c in the rows layout, n / (hw * c)
// in the planes layout. y may be null when relu is 0. Two launches on
// `stream`; returns the cudaError_t after both.
extern "C" int dvt_bn_act_bwd(const void* g, const void* x, const void* y,
                              const void* scale, void* dx, void* dres,
                              void* partial, void* dscale, void* dbias,
                              long long n, int c, long long hw,
                              int planes_layout, int dtype, int relu,
                              int blocks, long long stride,
                              long long partial_rows, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  float2* part = static_cast<float2*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dispatch_bwd<__nv_bfloat16>(dres != nullptr, relu, g, x, y, sc, dx, dres,
                                part, n, c, hw, planes_layout, blocks, stride,
                                s);
  else
    dispatch_bwd<float>(dres != nullptr, relu, g, x, y, sc, dx, dres, part, n,
                        c, hw, planes_layout, blocks, stride, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kColumnSumCols, kColumnSumGroups);
  const unsigned grid = static_cast<unsigned>((c + kColumnSumCols - 1) /
                                              kColumnSumCols);
  reduce_partials<<<grid, block, 0, s>>>(part, partial_rows, c,
                                         static_cast<float*>(dscale),
                                         static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}
