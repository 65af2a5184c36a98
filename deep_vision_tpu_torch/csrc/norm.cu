// BatchNorm batch moments and LayerNorm, forward and backward, for Hopper
// (sm_90a).
//
// Replaces two XLA fusions of the JAX package, which no Pallas kernel
// covers: the training BatchNorm's statistics (deep_vision_tpu/nn/
// layers.py:129-137, E[x] and E[x^2] in f32 in one pass over x) and flax's
// LayerNorm (deep_vision_tpu/models/vit.py:156, :158, :225: f32 statistics
// with the fast variance, output in the layer's dtype). The kernels:
//
//   bn_moments_fwd   per-channel sum x, sum x^2 over the rows of a (rows, C)
//                    matrix (C innermost: channels_last 4-D or (N, C)),
//                    added up inside a thread-block cluster -> E1, E2; where
//                    one cluster does not cover a chunk's rows, each cluster
//                    writes one partial row and bn_moments_combine adds them
//   bn_moments_bwd   dx = alpha[c] + beta[c] * x, with alpha = dE1 / N and
//                    beta = (2 dE2) / N formed in the kernel (IEEE division;
//                    N rounded to float as PyTorch rounds the int)
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
// bn_moments_bwd equals its plain version bit for bit, and E1, E2 equal
// ops/cuda/norm.py's moments_order_model, the model of the order below,
// bit for bit (tests/test_torch_norm_plan.py holds the model against a
// thread-by-thread loop and a float64 sum). LayerNorm's outputs differ from
// the plain versions only by the order of their sums.
//
// The moments forward. A thread owns one 16-byte vector of channels (8 bf16
// or 4 f32; one element when C is not a multiple of that) for all its rows.
// A CTA of 256 threads is `cols` vectors of one column chunk by `lanes` =
// 256 / cols rows at a time. The grid is (cluster x clusters, chunks) CTAs,
// clusters of `cluster` along x, and CTA b's rank is b % cluster
// (ops/cuda/norm.py's moments_plan). Per channel, the order of the sums is:
//   1. the thread of lane l in CTA b sums x and x^2 over rows b * lanes + l,
//      + stride, + 2 stride, ... (stride = cluster x clusters x lanes: the
//      grid sweeps x front to back together) in order, in batches of 8
//      rows whose 16-byte loads are all in flight before the first add
//      (streaming loads, evict-first: x is read once, so the lines other
//      kernels left in L2 stay, and no dirty one is written back for it);
//   2. the CTA adds its lanes in order, in shared memory, and pushes each
//      sum into the shared memory of the rank that owns it
//      (map_shared_rank; item k belongs to rank k % cluster);
//   3. after one cluster barrier each rank adds the pushed sums of its
//      items in rank order, from its own shared memory;
//   4. with one cluster a chunk, it divides by the row count and writes
//      E1, E2: one launch, no partial buffer, no combine; else it writes
//      its sums as partial row b / cluster, and bn_moments_combine adds the
//      partial rows in column_sum's fixed order and divides.
// The pushes wait on a barrier that each CTA arrives at when it starts
// (barrier.cluster.arrive.relaxed) and waits on after its loads, so no
// rank writes into a peer that has not started, at no cost; nothing
// crosses the cluster after the full barrier, so a CTA may leave at once.
// Clusters have up to 16 CTAs (cudaFuncAttributeNonPortableClusterSizeAllowed,
// set once a device) and are launched by cudaLaunchKernelEx; a refused
// attribute or launch returns its error, which the wrapper raises. Small
// shapes get narrow chunks, down to 128 bytes of a row, so that chunks x
// 16 CTAs fill the card in one launch (2,704 x 1,024 f32: 16 chunks of 64
// channels, 256 CTAs); one cluster covers a chunk while a thread sums at
// most 128 rows (every shape up to 52 x 52 x 16 of YOLOv3 and 14 x 14 x
// 128 of ResNet-50). Taller shapes (2.77 M x 32, 1.6 M x 64) take chunks
// up to 256 vectors wide and clusters of 4 CTAs, 2 CTAs an SM, each thread
// keeping at least 16 rows: 66 clusters, 66 partial rows, then the
// combine. (One launch there, with a last-cluster-done counter, measured
// no faster on the H100 than the combine's launch queued behind it.)
//
// The moments backward lays its threads out as the forward does: a thread
// forms alpha and beta of its vector once, keeps them in registers and
// walks rows with the grid's stride, 4 16-byte loads in flight; the grid
// is sized to the tensor: at least 4 rows a thread, at most 4 CTAs an SM,
// one wave at its registers.
//
// LayerNorm: 16-byte vectors along a row when D is a multiple of 8 (bf16)
// or 4 (f32), else single elements. A lane keeps vectors lane, lane + 32,
// ... of the row in registers between the statistics and the write (384
// bf16 = 48 vectors: two slots a lane, the second empty on lanes 16-31), so
// x is read once; a row is at most 1,024 elements (32 a lane). Every tensor
// x, y or dx starts on a 16-byte boundary (the wrapper checks).
//
// What bounds it. Bytes: the moments forward reads x once (its partial
// rows, where it has any, are a few KB), the backward reads x and writes
// dx; LayerNorm reads x and writes y, its backward reads x and g and writes
// dx. Each does a few flops per element, far below the H100's ~295 flops a
// byte, so the time is memory traffic: the bound is the bytes over 3.35
// TB/s. At a step's small shapes (2,704 to 43,264 rows, 3 to 44 MB) a
// call's fixed cost, its launches and the first loads' latency, is as large
// as its bytes' time: one launch a call and enough loads in flight on every
// SM are what the moments design is for. A later version could fold the
// moments backward into bn_act's backward (dx += alpha + beta * x in the
// same pass), fold the statistics into the producing kernels, and keep
// LayerNorm's loads in flight across rows.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRow = 1024;  // LayerNorm: 32 lanes x 32 elements
// the moments forward: 16-byte loads in flight a thread, CTAs an SM its
// registers must allow (ops/cuda/norm.py's MOMENTS_CTAS_PER_SM takes 2),
// CTAs a cluster (above kPortableCluster only with the non-portable
// attribute)
constexpr int kFwdUnroll = 8;
constexpr int kFwdCtasPerSm = 3;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
// the moments backward: 16-byte loads in flight a thread
constexpr int kBwdUnroll = 4;

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

// one ld.global.cs (cache streaming: evict-first in L1 and L2) of the
// vector at p: the moments forward reads x once, so its lines are the
// first to go, and not the lines other kernels left in L2
template <typename V>
__device__ __forceinline__ V load_streaming(const V* p) {
  using U = std::conditional_t<
      sizeof(V) == 16, uint4,
      std::conditional_t<sizeof(V) == 4, unsigned, unsigned short>>;
  static_assert(sizeof(V) == sizeof(U), "a vector of 16, 4 or 2 bytes");
  const U u = __ldcs(reinterpret_cast<const U*>(p));
  V v;
  memcpy(&v, &u, sizeof(V));
  return v;
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

// grid (cluster x clusters, chunks), launched in clusters of (cluster, 1,
// 1). CTA b = blockIdx.x covers column chunk blockIdx.y: thread t is (lane
// t / cols, column t % cols) and sums x and x^2 of its vector over rows b *
// lanes + lane, + stride, ... in order; the CTA adds its lanes in order and
// pushes item k's sum to rank k % cluster, slot (k / cluster) * cluster +
// its rank; each rank adds its items' slots in rank order. Then, with one
// cluster, E = sum / rows into out[0:c], out[c:2c]; else the sums into
// partial row b / cluster of out[2c:], a (clusters, 2, c) matrix.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kFwdCtasPerSm)
bn_moments_fwd(const T* __restrict__ x, float* __restrict__ out,
               int64_t rows, int c, int cols) {
  using V = Vec<T, VEC>;
  // red[(lane * cols + col) * 2 VEC + stat * VEC + e]; got: the ranks'
  // sums of the items this rank owns
  __shared__ float red[kThreads * 2 * VEC];
  __shared__ float got[kThreads * 2 * VEC + kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA has started: once every rank has arrived (the wait below,
  // after the loads), its peers may write into its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int clusters = static_cast<int>(gridDim.x) / ranks;
  float* partial = out + 2 * static_cast<int64_t>(c);  // (clusters, 2, c)
  const int vectors = c / VEC;
  const int lanes = kThreads / cols;
  const int lane = threadIdx.x / cols;
  const int v = blockIdx.y * cols + threadIdx.x % cols;
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.0f;
  // the thread's rows: blockIdx.x * lanes + lane, + stride, ... (the
  // whole grid sweeps x from front to back together)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * lanes;
  if (lane < lanes && v < vectors) {
    const T* base = x + static_cast<int64_t>(v) * VEC;
    // batches of kFwdUnroll rows, every load of a batch issued before its
    // first add; rows past the end read as zeros, which change no sum (a
    // sum that starts at +0.0 is never -0.0)
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * lanes + lane;
         r < rows; r += kFwdUnroll * stride) {
      V raw[kFwdUnroll];
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u) {
        const int64_t ru = r + u * stride;
        raw[u] = ru < rows ? load_streaming(reinterpret_cast<const V*>(
                                 base + ru * c))
                           : V{};
      }
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float t = to_f32(raw[u].v[e]);
          s[e] += t;
          q[e] += t * t;  // no FMA: built with --fmad=false
        }
      }
    }
  }
  float* mine = red + threadIdx.x * 2 * VEC;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mine[e] = s[e];
    mine[VEC + e] = q[e];
  }
  __syncthreads();
  // the CTA's sum of item k, its lanes added in order, goes to the
  // rank that owns k (k % ranks), into slot (k / ranks) * ranks + rank of
  // that rank's `got`: every value crosses the cluster before the one full
  // barrier, and after it each rank reads only its own shared memory
  const int items = cols * 2 * VEC;  // (column, stat, element) of a lane
  const int rank = static_cast<int>(cluster.block_rank());
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int k = threadIdx.x; k < items; k += kThreads) {
    float t = red[k];
#pragma unroll 8
    for (int l = 1; l < lanes; ++l) t += red[l * items + k];
    *cluster.map_shared_rank(got + (k / ranks) * ranks + rank, k % ranks) =
        t;
  }
  cluster.sync();  // every push has landed; no rank touches a peer after
  for (int k = rank + ranks * static_cast<int>(threadIdx.x); k < items;
       k += ranks * kThreads) {
    const float* slots = got + (k / ranks) * ranks;
    float part[kMaxCluster];  // every load in flight, then the adds
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) part[r] = r < ranks ? slots[r] : 0.0f;
    float t = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < ranks) t += part[r];
    const int vv = blockIdx.y * cols + k / (2 * VEC);
    if (vv >= vectors) continue;
    const int stat = (k / VEC) & 1;
    const int ch = vv * VEC + k % VEC;
    if (clusters == 1) {
      out[stat * c + ch] = __fdiv_rn(t, static_cast<float>(rows));
    } else {
      partial[(2 * static_cast<int64_t>(blockIdx.x / ranks) + stat) * c +
              ch] = t;
    }
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
    out[ch] = __fdiv_rn(t.x, n);
    out[c + ch] = __fdiv_rn(t.y, n);
  }
}

// dx = alpha + beta * x. grid (row blocks, chunks): thread t of block (b,
// chunk) is (lane t / cols, column t % cols) of vector v = chunk * cols +
// column. It forms alpha = dE1 / rows and beta = (2 dE2) / rows of its
// channels once, IEEE divisions as PyTorch's float32 `/`, and keeps them in
// registers over rows b * lanes + lane, + gridDim.x * lanes, ...
// (--fmad=false rounds beta * x before the add, as the plain version).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_bwd(const T* __restrict__ x, const float* __restrict__ d_mean,
               int64_t mean_stride, const float* __restrict__ d_mean2,
               int64_t mean2_stride, T* __restrict__ dx, int64_t rows, int c,
               int cols) {
  const int lanes = kThreads / cols;
  const int lane = threadIdx.x / cols;
  const int v = blockIdx.y * cols + threadIdx.x % cols;
  if (lane >= lanes || v >= c / VEC) return;
  const float n = static_cast<float>(rows);
  float a[VEC], b[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int64_t ch = static_cast<int64_t>(v) * VEC + e;
    a[e] = __fdiv_rn(d_mean[ch * mean_stride], n);
    b[e] = __fdiv_rn(2.0f * d_mean2[ch * mean2_stride], n);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * lanes;
  const T* xs = x + static_cast<int64_t>(v) * VEC;
  T* ds = dx + static_cast<int64_t>(v) * VEC;
  int64_t r = static_cast<int64_t>(blockIdx.x) * lanes + lane;
  for (; r + (kBwdUnroll - 1) * step < rows; r += kBwdUnroll * step) {
    float t[kBwdUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      load<T, VEC>(xs + (r + u * step) * c, t[u]);
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = a[e] + b[e] * t[u][e];
      store<T, VEC>(ds + (r + u * step) * c, o);
    }
  }
  for (; r < rows; r += step) {
    float t[VEC], o[VEC];
    load<T, VEC>(xs + r * c, t);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = a[e] + b[e] * t[e];
    store<T, VEC>(ds + r * c, o);
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

// cudaFuncAttributeNonPortableClusterSizeAllowed on bn_moments_fwd<T, VEC>,
// set once a device (devices 0-63; others each call)
template <typename T, int VEC>
cudaError_t allow_wide_clusters(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      bn_moments_fwd<T, VEC>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// Threads per block of the row kernels (the wrapper plans grids with it).
extern "C" int dvt_norm_threads() { return kThreads; }

// E1 = sum x / rows and E2 = sum x^2 / rows per channel of a (rows, c)
// matrix of dtype (0 f32, 1 bf16), into out[0:c] and out[c:2c]. vec is 16 /
// element size when c is a multiple of it, else 1; the grid is (cluster x
// clusters, chunks) CTAs of `cols` vector columns, in clusters of `cluster`
// CTAs (ops/cuda/norm.py's moments_plan). One launch on `stream` with one
// cluster a chunk; with several, the clusters' sums go to out[2c:], a
// (clusters, 2, c) float scratch, and bn_moments_combine is a second
// launch. Returns the first cudaError_t.
extern "C" int dvt_bn_moments_fwd(const void* x, void* out, long long rows,
                                  int c, int dtype, int vec, int cols,
                                  int chunks, int cluster, int clusters,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * clusters),
                     static_cast<unsigned>(chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const bool ok = pick_vec(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int kVec = decltype(v)::value;
    if (cluster > kPortableCluster) err = allow_wide_clusters<T, kVec>(device);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, bn_moments_fwd<T, kVec>,
                               static_cast<const T*>(x),
                               static_cast<float*>(out),
                               static_cast<int64_t>(rows), c, cols);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported here, not later
    return static_cast<int>(err);
  }
  if (clusters == 1) return static_cast<int>(cudaGetLastError());
  float* sums = static_cast<float*>(out);
  const dim3 block(kColumnSumCols, kColumnSumGroups);
  bn_moments_combine<<<(c + kColumnSumCols - 1) / kColumnSumCols, block, 0,
                       s>>>(sums + 2 * static_cast<int64_t>(c), clusters, c,
                            rows, sums);
  return static_cast<int>(cudaGetLastError());
}

// dx = alpha + beta * x over a (rows, c) matrix of dtype, dx in x's layout,
// with alpha = d_mean / rows and beta = (2 d_mean2) / rows formed in the
// kernel from d_mean[ch * mean_stride] and d_mean2[ch * mean2_stride]. The
// grid is (blocks, chunks) CTAs of `cols` vector columns
// (ops/cuda/norm.py's moments_bwd_plan). One launch on `stream`.
extern "C" int dvt_bn_moments_bwd(const void* x, const void* d_mean,
                                  long long mean_stride, const void* d_mean2,
                                  long long mean2_stride, void* dx,
                                  long long rows, int c, int dtype, int vec,
                                  int cols, int chunks, int blocks,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(chunks));
  return finish(pick_vec(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int kVec = decltype(v)::value;
    bn_moments_bwd<T, kVec><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(d_mean),
        mean_stride, static_cast<const float*>(d_mean2), mean2_stride,
        static_cast<T*>(dx), rows, c, cols);
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
