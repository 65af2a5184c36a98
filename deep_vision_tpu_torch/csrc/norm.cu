// BatchNorm batch moments and LayerNorm, forward and backward, for Hopper
// (sm_90a).
//
// Replaces two XLA fusions of the JAX package, which no Pallas kernel
// covers: the training BatchNorm's statistics (deep_vision_tpu/nn/
// layers.py:129-137, E[x] and E[x^2] in f32 in one pass over x) and flax's
// LayerNorm (deep_vision_tpu/models/vit.py:156, :158, :225: f32 statistics
// with the fast variance, output in the layer's dtype). Four kernels; the
// two that sum across blocks end in a fixed-order combine launch, as
// bn_act's backward does:
//
//   bn_moments_fwd   per-channel sum x, sum x^2 over the rows of a (rows, C)
//                    matrix (C innermost: channels_last 4-D or (N, C)):
//                    each block sums a range of rows into one partial row,
//                    then bn_moments_combine adds the partial rows in a
//                    fixed order and divides by the row count -> E1, E2
//   bn_moments_bwd   dx = alpha[c] + beta[c] * x   (alpha = dE1 / N and
//                    beta = 2 dE2 / N, computed by the wrapper)
//   layer_norm_fwd   a warp per row: mean, E[x^2], var = max(E[x^2] -
//                    mean^2, 0), rstd = 1 / sqrt(var + eps), y = (x - mean)
//                    * (rstd * scale) + bias rounded once to the output
//                    dtype; saves mean and rstd per row
//   layer_norm_bwd   a warp per row at a time: x^ = (x - mean) * rstd, h =
//                    g * scale, dx = (h - (sum h / D + x^ * [E[x^2] -
//                    mean^2 >= 0] * sum h x^ / D)) * rstd; dscale = sum g x^
//                    and dbias = sum g per column in registers across the
//                    warp's rows, added over the block's warps in order, and
//                    over the blocks by layer_norm_bwd_combine
//
// Every sum has a fixed order: no float atomics, so every output repeats
// bit for bit from run to run on one card. The build uses --fmad=false, so a
// multiply and an add round apart as in the plain PyTorch versions: dx of
// bn_moments_bwd equals its plain version bit for bit, and the moments'
// order is modelled exactly by ops/cuda/norm.py's moments_order_model
// (tests/test_torch_norm_plan.py holds that order against a float64 sum at
// the ResNet step's extreme shapes). The other outputs differ from the
// plain versions only by the order of their sums.
//
// Layouts: 16-byte vectors (8 bf16 or 4 f32) along C or along a row when C
// or D is a multiple of 8 (bf16) or 4 (f32), else single elements; every
// tensor starts on a 16-byte boundary (the wrapper checks). A thread of the
// moments kernel keeps one vector of channels for all its rows, so the
// channel is fixed; the moments grid (the wrapper's moments_plan) splits
// the rows into about 4 blocks an SM: C = 64 reads 32 rows a block at a
// time, C = 2048 one row, 256 vectors wide. A LayerNorm lane keeps its
// vectors lane, lane + 32, ... of the row in registers between the
// statistics and the write (384 bf16 = 48 vectors: two slots a lane, the
// second empty on lanes 16-31), so x is read once; a row is at most 1,024
// elements (32 a lane).
//
// What bounds it. Bytes: the moments forward reads x once (plus its partial
// rows, written and read once: 8.6 MB against x's 25.7 MB at 6,272 x 2,048,
// a few percent of x at the large shapes), the backward reads x and writes
// dx; LayerNorm reads x and writes y, its backward reads x and g and writes
// dx. Each does a few flops per element, far below the H100's ~295 flops a
// byte, so the time is memory traffic: the bound is the bytes over 3.35
// TB/s. This first version makes one pass each with 16-byte loads and no
// tuning; a later one could fold the moments backward into bn_act's
// backward (dx += alpha + beta * x in the same pass), fold the statistics
// into the producing kernels, size the moments grid so that small shapes
// pay less fixed cost and wide ones fewer partial rows, and keep
// LayerNorm's loads in flight across rows.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxRow = 1024;  // LayerNorm: 32 lanes x 32 elements

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

// N consecutive elements, loaded or stored as one access of up to 16 bytes
// (two for 8 f32)
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p,
                                     float (&out)[N]) {
  const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_f32(v.v[e]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p,
                                      const float (&in)[N]) {
  Vec<T, N> v;
#pragma unroll
  for (int e = 0; e < N; ++e) v.v[e] = from_f32<T>(in[e]);
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// butterfly: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (row j, stat 0 and 1, column ch) of a (rows, 2, c) partial matrix
__device__ __forceinline__ float2 stat_pair(const float* __restrict__ partial,
                                            int c, int64_t j, int ch) {
  return make_float2(partial[(2 * j) * c + ch], partial[(2 * j + 1) * c + ch]);
}

// -- BatchNorm moments -------------------------------------------------------

// grid (splits, column chunks). Thread t of the block is (lane t / cols,
// column t % cols); it sums x and x^2 of its vector of channels over rows
// start + lane, start + lane + lanes, ... below end, in order, then the
// block adds its lanes in order into partial row blockIdx.x.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_fwd(const T* __restrict__ x, float* __restrict__ partial,
               int64_t rows, int c, int cols, int64_t rows_per_split) {
  __shared__ float red[kThreads * 2 * VEC];
  const int vectors = c / VEC;
  const int lanes = kThreads / cols;
  const int lane = threadIdx.x / cols;
  const int col = threadIdx.x % cols;
  const int v = blockIdx.y * cols + col;
  const bool active = lane < lanes && v < vectors;
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.0f;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * rows_per_split;
  const int64_t end =
      start + rows_per_split < rows ? start + rows_per_split : rows;
  if (active) {
    const T* base = x + static_cast<int64_t>(v) * VEC;
    int64_t r = start + lane;
    for (; r + (kUnroll - 1) * lanes < end; r += kUnroll * lanes) {
      float t[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load<T, VEC>(base + (r + u * lanes) * c, t[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s[e] += t[u][e];
          q[e] += t[u][e] * t[u][e];  // no FMA: built with --fmad=false
        }
      }
    }
    for (; r < end; r += lanes) {
      float t[VEC];
      load<T, VEC>(base + r * c, t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += t[e];
        q[e] += t[e] * t[e];
      }
    }
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
  if (lanes == 1) {  // one row at a time: the thread's sums are the block's
    if (active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[v * VEC + e] = s[e];
        out[c + v * VEC + e] = q[e];
      }
    }
    return;
  }
  // red[(lane * cols + col) * 2 VEC + stat * VEC + e]
  if (active) {
    float* mine = red + threadIdx.x * 2 * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mine[e] = s[e];
      mine[VEC + e] = q[e];
    }
  }
  __syncthreads();
  const int items = cols * 2 * VEC;  // (column, stat, element) of lane 0
  for (int k = threadIdx.x; k < items; k += kThreads) {
    const int kc = k / (2 * VEC);
    const int stat = (k / VEC) & 1;
    const int e = k % VEC;
    const int vv = blockIdx.y * cols + kc;
    if (vv >= vectors) continue;
    float t = red[k];
    for (int l = 1; l < lanes; ++l) t += red[l * items + k];
    out[stat * c + vv * VEC + e] = t;
  }
}

// out[0][ch], out[1][ch] = E[x], E[x^2]: the partial rows' column sums in
// column_sum's fixed order, over the rows
__global__ void __launch_bounds__(kColumnSumCols * kColumnSumGroups)
bn_moments_combine(const float* __restrict__ partial, int64_t splits, int c,
                   int64_t rows, float* __restrict__ out) {
  int ch;
  float2 t;
  if (column_sum(splits, c,
                 [=](int64_t j, int k) { return stat_pair(partial, c, j, k); },
                 ch, t)) {
    const float n = static_cast<float>(rows);
    out[ch] = t.x / n;
    out[c + ch] = t.y / n;
  }
}

// dx = alpha[ch] + beta[ch] * x over n elements, channel = index mod c
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_bwd(const T* __restrict__ x, const float* __restrict__ alpha,
               const float* __restrict__ beta, T* __restrict__ dx, int64_t n,
               int c) {
  const int64_t vectors = n / VEC;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
#pragma unroll 4
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < vectors; j += step) {
    const int ch = static_cast<int>((j * VEC) % c);
    float v[VEC], a[VEC], b[VEC], out[VEC];
    load<T, VEC>(x + j * VEC, v);
    load<float, VEC>(alpha + ch, a);
    load<float, VEC>(beta + ch, b);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = a[e] + b[e] * v[e];
    store<T, VEC>(dx + j * VEC, out);
  }
}

// -- LayerNorm ---------------------------------------------------------------

// one warp a row; lane slot p holds vector lane + 32 p of the row (zeros
// past its end, which add nothing to the sums)
template <typename TIn, typename TOut, int VEC, int PER>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd(const TIn* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, TOut* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vectors = d / VEC;
  const TIn* xr = x + row * d;
  float v[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (j < vectors) {
      load<TIn, VEC>(xr + j * VEC, v[p]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[p][e] = 0.0f;
    }
  }
  float s = 0.0f, q = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s += v[p][e];
      q += v[p][e] * v[p][e];
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float df = static_cast<float>(d);
  const float mean = s / df;
  const float diff = q / df - mean * mean;
  const float var = diff < 0.0f ? 0.0f : diff;  // keeps a NaN, as clamp_min
  const float rstd = 1.0f / sqrtf(var + eps);
  TOut* yr = y + row * d;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + 32 * p;
    if (j >= vectors) continue;
    float sc[VEC], bi[VEC], out[VEC];
    load<float, VEC>(scale + j * VEC, sc);
    load<float, VEC>(bias + j * VEC, bi);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = (v[p][e] - mean) * (rstd * sc[e]) + bi[e];
    store<TOut, VEC>(yr + j * VEC, out);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// warps walk the rows with a stride of gridDim.x * kWarps; each lane keeps
// dscale and dbias of its columns in registers, the block adds its warps in
// order into partial row blockIdx.x
template <typename TIn, typename TG, int VEC, int PER>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd(const TIn* __restrict__ x, const TG* __restrict__ g,
               const float* __restrict__ scale,
               const float* __restrict__ mean_in,
               const float* __restrict__ rstd_in, TIn* __restrict__ dx,
               float* __restrict__ partial, int64_t rows, int d) {
  __shared__ float red[2][kMaxRow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vectors = d / VEC;
  const float df = static_cast<float>(d);
  float ds[PER][VEC], db[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[p][e] = db[p][e] = 0.0f;
  }
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       row < rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    float xv[PER][VEC], gv[PER][VEC];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = lane + 32 * p;
      if (j < vectors) {
        load<TIn, VEC>(x + row * d + j * VEC, xv[p]);
        load<TG, VEC>(g + row * d + j * VEC, gv[p]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[p][e] = gv[p][e] = 0.0f;
      }
    }
    const float mu = mean_in[row];
    const float r = rstd_in[row];
    // the forward's E[x^2], in its order: the clamp's mask
    float q = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) q += xv[p][e] * xv[p][e];
    }
    q = warp_sum(q);
    const bool keep = q / df - mu * mu >= 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = lane + 32 * p;
      if (j >= vectors) continue;
      float sc[VEC];
      load<float, VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float h = gv[p][e] * sc[e];
        const float xh = (xv[p][e] - mu) * r;
        s1 += h;
        s2 += h * xh;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float a = s1 / df;
    const float b = keep ? s2 / df : 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = lane + 32 * p;
      if (j >= vectors) continue;
      float sc[VEC], out[VEC];
      load<float, VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float h = gv[p][e] * sc[e];
        const float xh = (xv[p][e] - mu) * r;
        out[e] = (h - (a + xh * b)) * r;
        ds[p][e] += gv[p][e] * xh;
        db[p][e] += gv[p][e];
      }
      store<TIn, VEC>(dx + row * d + j * VEC, out);
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int j = lane + 32 * p;
        if (j >= vectors) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = j * VEC + e;
          red[0][col] = w == 0 ? ds[p][e] : red[0][col] + ds[p][e];
          red[1][col] = w == 0 ? db[p][e] : red[1][col] + db[p][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * d;
  for (int k = threadIdx.x; k < d; k += kThreads) {
    out[k] = red[0][k];
    out[d + k] = red[1][k];
  }
}

// dscale, dbias: the blocks' partial rows summed in column_sum's fixed order
__global__ void __launch_bounds__(kColumnSumCols * kColumnSumGroups)
layer_norm_bwd_combine(const float* __restrict__ partial, int64_t blocks,
                       int d, float* __restrict__ dscale,
                       float* __restrict__ dbias) {
  int ch;
  float2 t;
  if (column_sum(blocks, d,
                 [=](int64_t j, int k) { return stat_pair(partial, d, j, k); },
                 ch, t)) {
    dscale[ch] = t.x;
    dbias[ch] = t.y;
  }
}

// -- dispatch ----------------------------------------------------------------

// calls f(std::integral_constant<int, P>) for the P in Ps equal to per;
// false when none is
template <int P, int... Rest, typename F>
bool pick(int per, F&& f) {
  if (per == P) {
    f(std::integral_constant<int, P>{});
    return true;
  }
  if constexpr (sizeof...(Rest) > 0) {
    return pick<Rest...>(per, f);
  } else {
    return false;
  }
}

// the slots a LayerNorm lane may have at a vector width: up to 32 elements
// (ops/cuda/norm.py's ln_slots)
template <int VEC, typename F>
bool pick_per(int per, F&& f) {
  if constexpr (VEC == 1) {
    return pick<8, 32>(per, f);
  } else if constexpr (VEC == 4) {
    return pick<1, 2, 4, 8>(per, f);
  } else {
    return pick<1, 2, 4>(per, f);
  }
}

// calls f(TIn{}, std::integral_constant<int, VEC>) for the dtype (0 f32,
// 1 bf16) and the vector width (16 bytes or 1 element); false for others
template <typename F>
bool pick_vec(int dtype, int vec, F&& f) {
  if (dtype == 0 && vec == 4) {
    f(float{}, std::integral_constant<int, 4>{});
  } else if (dtype == 0 && vec == 1) {
    f(float{}, std::integral_constant<int, 1>{});
  } else if (dtype == 1 && vec == 8) {
    f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
  } else if (dtype == 1 && vec == 1) {
    f(__nv_bfloat16{}, std::integral_constant<int, 1>{});
  } else {
    return false;
  }
  return true;
}

template <typename F>
bool pick_dtype(int dtype, F&& f) {
  if (dtype == 0) {
    f(float{});
  } else if (dtype == 1) {
    f(__nv_bfloat16{});
  } else {
    return false;
  }
  return true;
}

int finish(bool launched) {
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Threads per block of the row kernels (the wrapper plans grids with it).
extern "C" int dvt_norm_threads() { return kThreads; }

// E1 = sum x / rows and E2 = sum x^2 / rows per channel of a (rows, c)
// matrix of dtype (0 f32, 1 bf16), written to out[0:c] and out[c:2c] through
// `partial`, a (splits, 2, c) float scratch. vec is 16 / element size when c
// is a multiple of it, else 1; the grid is (splits, col_blocks) blocks of
// `cols` vector columns (ops/cuda/norm.py's moments_plan). Two launches on
// `stream`; returns the cudaError_t after both.
extern "C" int dvt_bn_moments_fwd(const void* x, void* partial, void* out,
                                  long long rows, int c, int dtype, int vec,
                                  int cols, int col_blocks, int splits,
                                  long long rows_per_split, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(col_blocks));
  const bool ok = pick_vec(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int kVec = decltype(v)::value;
    bn_moments_fwd<T, kVec><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), part, rows, c, cols, rows_per_split);
  });
  const int first = finish(ok);
  if (first != 0) return first;
  const dim3 block(kColumnSumCols, kColumnSumGroups);
  bn_moments_combine<<<(c + kColumnSumCols - 1) / kColumnSumCols, block, 0,
                       s>>>(
      part, splits, c, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// dx = alpha[ch] + beta[ch] * x over n elements of dtype with channel =
// index mod c, in a grid-stride loop over `blocks` blocks; dx has x's layout.
extern "C" int dvt_bn_moments_bwd(const void* x, const void* alpha,
                                  const void* beta, void* dx, long long n,
                                  int c, int dtype, int vec, int blocks,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return finish(pick_vec(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int kVec = decltype(v)::value;
    bn_moments_bwd<T, kVec><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(alpha),
        static_cast<const float*>(beta), static_cast<T*>(dx), n, c);
  }));
}

// LayerNorm over rows of d contiguous elements: y (out_dtype), mean and
// rstd (rows floats each). vec and per as ops/cuda/norm.py's
// layer_norm_plan gives them; `blocks` blocks of kWarps rows.
extern "C" int dvt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* rstd, long long rows, int d,
                                  float eps, int in_dtype, int out_dtype,
                                  int vec, int per, int blocks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  pick_vec(in_dtype, vec, [&](auto ti, auto v) {
    using TIn = decltype(ti);
    constexpr int kVec = decltype(v)::value;
    pick_dtype(out_dtype, [&](auto to) {
      using TOut = decltype(to);
      ok = pick_per<kVec>(per, [&](auto pp) {
        constexpr int kPer = decltype(pp)::value;
        layer_norm_fwd<TIn, TOut, kVec, kPer><<<blocks, kThreads, 0, s>>>(
            static_cast<const TIn*>(x), static_cast<const float*>(scale),
            static_cast<const float*>(bias), static_cast<TOut*>(y),
            static_cast<float*>(mean), static_cast<float*>(rstd), rows, d,
            eps);
      });
    });
  });
  return finish(ok);
}

// The LayerNorm backward: dx (x's dtype) from x, g (g_dtype), scale and the
// forward's mean and rstd; dscale and dbias (d floats each) through
// `partial`, a (blocks, 2, d) float scratch. Two launches on `stream`;
// returns the cudaError_t after both.
extern "C" int dvt_layer_norm_bwd(const void* x, const void* g,
                                  const void* scale, const void* mean,
                                  const void* rstd, void* dx, void* partial,
                                  void* dscale, void* dbias, long long rows,
                                  int d, int in_dtype, int g_dtype, int vec,
                                  int per, int blocks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  bool ok = false;
  pick_vec(in_dtype, vec, [&](auto ti, auto v) {
    using TIn = decltype(ti);
    constexpr int kVec = decltype(v)::value;
    pick_dtype(g_dtype, [&](auto tg) {
      using TG = decltype(tg);
      ok = pick_per<kVec>(per, [&](auto pp) {
        constexpr int kPer = decltype(pp)::value;
        layer_norm_bwd<TIn, TG, kVec, kPer><<<blocks, kThreads, 0, s>>>(
            static_cast<const TIn*>(x), static_cast<const TG*>(g),
            static_cast<const float*>(scale),
            static_cast<const float*>(mean),
            static_cast<const float*>(rstd), static_cast<TIn*>(dx), part,
            rows, d);
      });
    });
  });
  const int first = finish(ok);
  if (first != 0) return first;
  const dim3 block(kColumnSumCols, kColumnSumGroups);
  layer_norm_bwd_combine<<<(d + kColumnSumCols - 1) / kColumnSumCols, block,
                           0, s>>>(part, blocks, d,
                                   static_cast<float*>(dscale),
                                   static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}
