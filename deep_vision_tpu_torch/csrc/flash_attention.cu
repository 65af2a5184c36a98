// Flash attention for Hopper (sm_90a): the forward and its dq / dkv backward.
//
// Replaces the TPU kernels of deep_vision_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- `_flash_kernel` (:85, launched by `_flash_forward` at :171)
//   flash_dq   <- `_dq_kernel`    (:192, launched by `_flash_backward` at :308)
//   flash_dkv  <- `_dkv_kernel`   (:232, launched by `_flash_backward` at :324)
//
//   forward  S = Q K^T * scale (causal: S = -1e30 above the diagonal),
//            online softmax over key tiles: m = running max, l = running sum,
//            O = sum_k exp(S - m) V / max(l, 1e-20), lse = m + log(max(l, 1e-20))
//   dq       P = exp(S - lse), dP = dO V^T, dS = P (dP - delta) scale, dQ = dS K
//   dkv      dV = P^T dO, dK = dS^T Q
// with delta = rowsum(dO * O) (minus an lse cotangent) computed by the caller,
// as the reference computes it outside Pallas (:296-302).
//
// Layout. q, k, v and dO are (B, T, H, D) views given by their (batch, token,
// head) strides with stride 1 on D, so q, k and v can be the strided slices
// of a fused qkv projection's (B, T, 3, H, D) output. Outputs (out, dq, dk,
// dv) are contiguous (B, T, H, D); lse and delta are contiguous (B, H, T)
// f32 (the TPU's (B*H, T, 128) lane broadcast is a tiling artefact).
//
// Design. One CTA of 4 warps per (q tile of 64 rows, b, h) in the forward and
// dq kernels, looping over key tiles of 64 in order (the TPU's sequential
// grid axis becomes this loop); one CTA per (key tile of 64, b, h) in dkv,
// looping over query tiles, so dK and dV accumulate inside the CTA: no float
// atomics, deterministic results. Each warp owns 16 rows of every tile, so
// after the block-wide K/V (or Q/dO) tile load a warp works alone. Tiles
// live in shared memory, loaded with 16-byte accesses and zero-filled beyond
// T, Tk and D, so any T and Tk are taken without padding in memory (keys
// beyond Tk take no part in the softmax, queries beyond T are not written)
// and D is any multiple of 8 up to 128, computed at the next of 32, 64, 128.
//
// Products. bf16: tensor cores through nvcuda::wmma 16x16x16 bf16 fragments
// with f32 accumulation. Products of bf16 values are exact in f32, so S and
// dP match the TPU kernel's f32 dots up to summation order; P (forward, dkv)
// and dS (dq, dkv) are rounded to bf16 to enter the second products, where
// the TPU kernel keeps them in f32: a relative error of at most 2^-9 per
// term. f32: scalar multiply-adds on the CUDA cores, no TF32. Each product
// is written to the warp's f32 scratch, and its per-thread accumulators
// (fixed element -> lane mapping) add it in: rescaled by the online-softmax
// factor in the forward, plainly in the backward.
//
// What bounds it. At the ViT-S/16 512 step (B 64, T 1024, H 6, D 64, bf16)
// the work is 2 (forward), 3 (dq) or 4 (dkv) products of 2*T*T*D flops per
// head against ~200 MB of inputs: far above the H100's ~295 flops per byte,
// so the bound is the tensor cores (and the T*T exponentials on the SFUs).
// This first version does not come near it: synchronous wmma from shared
// memory, the scores round-tripping through shared memory, one exponential
// per score through expf, 4 warps a CTA. wgmma with TMA-fed, double-buffered
// tiles, scores kept in registers (the FlashAttention-2/3 layout) and
// exp2 with a folded log2(e) scale are the later steps.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // query rows and key columns per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;  // tile rows per warp
constexpr int kLdS = kTile + 4;        // f32 score tiles (wmma: ldm % 4 == 0)
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

// elements of padding per shared-memory row of T: 16 bytes, which keeps rows
// 16-byte aligned for the loads and wmma's ldm a multiple of 8 (bf16) or 4
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A (B, T, H, D) input: element (b, t, h, d) at p[b*sb + t*st + h*sh + d].
struct View {
  const void* p;
  int64_t sb, st, sh;
};

struct Dims {
  int B, H, T, Tk, D, causal;
  float scale;
};

// Rows [t0, t0 + kTile) of head (b, h) into a kTile x kD shared tile with
// leading dimension ld; zeros for rows at or beyond n and columns at or
// beyond d (a multiple of 8, so a 16-byte chunk is all in or all out).
template <typename T, int kD>
__device__ void load_tile(T* dst, int ld, const View& src, int b, int h,
                          int t0, int n, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = kD / kVec;
  const T* base = static_cast<const T*>(src.p) + b * src.sb + h * src.sh;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < n && c < d)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<int64_t>(t0 + r) * src.st + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// One warp: C (16 x N, f32, row-major, ldc) = A (16 x K, row-major, lda) * B
// with B(k, n) = b[n * ldb + k] when kBT (B stored transposed: a tile whose
// rows are B's columns) and b[k * ldb + n] otherwise.
template <int N, int K, bool kBT>
__device__ __forceinline__ void warp_gemm(const bf16* a, int lda,
                                          const bf16* b, int ldb, float* c,
                                          int ldc) {
  using namespace nvcuda;
  using BLayout =
      typename std::conditional<kBT, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int n = 0; n < N; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
      wmma::load_matrix_sync(fa, a + k, lda);
      wmma::load_matrix_sync(fb, kBT ? b + n * ldb + k : b + k * ldb + n,
                             ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + n, acc, ldc, wmma::mem_row_major);
  }
}

template <int N, int K, bool kBT>
__device__ __forceinline__ void warp_gemm(const float* a, int lda,
                                          const float* b, int ldb, float* c,
                                          int ldc) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < kRows * N; e += 32) {
    const int r = e / N, n = e % N;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      s += a[r * lda + k] * (kBT ? b[n * ldb + k] : b[k * ldb + n]);
    c[r * ldc + n] = s;
  }
}

// Shared-memory plan, in elements, shared by the three kernels: kTiles tiles
// of kTile x (kD + pad) T, kPTiles of kTile x (kTile + pad) T, a per-warp f32
// scratch (two score tiles of kRows x kLdS, or one kRows x (kD + 4) product,
// which aliases them), then kVecs per-row f32 vectors of kTile.
template <typename T, int kD, int kTiles, int kPTiles, int kVecs>
struct Plan {
  static constexpr int kLd = kD + pad<T>();
  static constexpr int kLdP = kTile + pad<T>();
  static constexpr int kLdO = kD + 4;
  static constexpr int kScratch =
      (2 * kLdS > kLdO ? 2 * kLdS : kLdO) * kRows;  // floats per warp
  static constexpr size_t kTileBytes = sizeof(T) * kTile * kLd;
  static constexpr size_t kPBytes = sizeof(T) * kTile * kLdP;
  static constexpr size_t kBytes = kTiles * kTileBytes + kPTiles * kPBytes +
                                   sizeof(float) * (kWarps * kScratch +
                                                    kVecs * kTile);
  __device__ static T* tile(unsigned char* s, int i) {
    return reinterpret_cast<T*>(s + i * kTileBytes);
  }
  __device__ static T* ptile(unsigned char* s, int i) {
    return reinterpret_cast<T*>(s + kTiles * kTileBytes + i * kPBytes);
  }
  __device__ static float* scratch(unsigned char* s, int warp) {
    return reinterpret_cast<float*>(s + kTiles * kTileBytes +
                                    kPTiles * kPBytes) +
           warp * kScratch;
  }
  __device__ static float* vec(unsigned char* s, int i) {
    return scratch(s, kWarps) + i * kTile;
  }
};

template <typename T, int kD>
using FwdPlan = Plan<T, kD, 3, 1, 3>;  // Q K V | P | m l alpha
template <typename T, int kD>
using DqPlan = Plan<T, kD, 4, 1, 2>;   // Q dO K V | dS | lse delta
template <typename T, int kD>
using DkvPlan = Plan<T, kD, 4, 2, 2>;  // K V Q dO | P^T dS^T | lse delta

// Accumulators: element e = lane + 32 i of the warp's kRows x kD block.
template <int kD>
struct Acc {
  static constexpr int kN = kRows * kD / 32;
  float v[kN];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = 0.0f;
  }
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(View q, View k, View v, T* __restrict__ out,
              float* __restrict__ lse, Dims s) {
  using P = FwdPlan<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = P::tile(smem, 0);
  T* ks = P::tile(smem, 1);
  T* vs = P::tile(smem, 2);
  T* ps = P::ptile(smem, 0);
  float* row_m = P::vec(smem, 0);
  float* row_l = P::vec(smem, 1);
  float* row_a = P::vec(smem, 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* sc = P::scratch(smem, warp);  // S, then the P V product
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<T, kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
  if (threadIdx.x < kTile) {
    row_m[threadIdx.x] = kNegInf;
    row_l[threadIdx.x] = 0.0f;
  }
  Acc<kD> acc;
  acc.zero();
  int nk = (s.Tk + kTile - 1) / kTile;
  if (s.causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);  // _block_visible

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile<T, kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
    load_tile<T, kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
    __syncthreads();
    warp_gemm<kTile, kD, true>(qs + r0 * P::kLd, P::kLd, ks, P::kLd, sc,
                               kLdS);
    __syncwarp();
    // online softmax, one row at a time; lane j holds columns j and j + 32
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r, qpos = q0 + row;
      float x[2];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, kpos = k0 + c;
        x[j] = -CUDART_INF_F;  // keys beyond Tk take no part
        if (kpos < s.Tk)
          x[j] = (s.causal && kpos > qpos) ? kNegInf
                                           : sc[r * kLdS + c] * s.scale;
        mx = fmaxf(mx, x[j]);
      }
      const float m_prev = row_m[row], l_prev = row_l[row];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(x[j] - m_new);
        sum += p;
        ps[row * P::kLdP + lane + 32 * j] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[row] = alpha;
        row_l[row] = l_prev * alpha + sum;
        row_m[row] = m_new;
      }
    }
    __syncwarp();
    warp_gemm<kD, kTile, false>(ps + r0 * P::kLdP, P::kLdP, vs, P::kLd, sc,
                                P::kLdO);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < Acc<kD>::kN; ++i) {
      const int e = lane + 32 * i, rr = e / kD, c = e % kD;
      acc.v[i] = acc.v[i] * row_a[r0 + rr] + sc[rr * P::kLdO + c];
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < Acc<kD>::kN; ++i) {
    const int e = lane + 32 * i, rr = e / kD, c = e % kD;
    const int t = q0 + r0 + rr;
    if (t < s.T && c < s.D) {
      const float l = fmaxf(row_l[r0 + rr], 1e-20f);
      out[((static_cast<int64_t>(b) * s.T + t) * s.H + h) * s.D + c] =
          from_f32<T>(acc.v[i] / l);
    }
  }
  if (lse != nullptr && lane < kRows) {
    const int row = r0 + lane, t = q0 + row;
    if (t < s.T)
      lse[static_cast<int64_t>(bh) * s.T + t] =
          row_m[row] + logf(fmaxf(row_l[row], 1e-20f));
  }
}

// lse and delta of rows [t0, t0 + kTile) of head bh into shared memory
// (0 beyond T: those rows are masked wherever they are read).
__device__ void load_rows(float* row_lse, float* row_delta, const float* lse,
                          const float* delta, int bh, int t0, int T) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    const int64_t i = static_cast<int64_t>(bh) * T + t;
    row_lse[threadIdx.x] = t < T ? lse[i] : 0.0f;
    row_delta[threadIdx.x] = t < T ? delta[i] : 0.0f;
  }
}

template <typename T, int kD>
__device__ void store_rows(T* __restrict__ dst, const Acc<kD>& acc, int b,
                           int h, int t0, int n, const Dims& s) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
#pragma unroll
  for (int i = 0; i < Acc<kD>::kN; ++i) {
    const int e = lane + 32 * i, rr = e / kD, c = e % kD;
    const int t = t0 + r0 + rr;
    if (t < n && c < s.D)
      dst[((static_cast<int64_t>(b) * n + t) * s.H + h) * s.D + c] =
          from_f32<T>(acc.v[i]);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dq(View q, View k, View v, View dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Dims s) {
  using P = DqPlan<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = P::tile(smem, 0);
  T* dos = P::tile(smem, 1);
  T* ks = P::tile(smem, 2);
  T* vs = P::tile(smem, 3);
  T* dss = P::ptile(smem, 0);
  float* row_lse = P::vec(smem, 0);
  float* row_delta = P::vec(smem, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* ss = P::scratch(smem, warp);  // S | dP, then the dS K product
  float* sdp = ss + kRows * kLdS;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<T, kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
  load_tile<T, kD>(dos, P::kLd, dout, b, h, q0, s.T, s.D);
  load_rows(row_lse, row_delta, lse, delta, bh, q0, s.T);
  Acc<kD> acc;
  acc.zero();
  int nk = (s.Tk + kTile - 1) / kTile;
  if (s.causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
    load_tile<T, kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
    __syncthreads();
    warp_gemm<kTile, kD, true>(qs + r0 * P::kLd, P::kLd, ks, P::kLd, ss,
                               kLdS);
    warp_gemm<kTile, kD, true>(dos + r0 * P::kLd, P::kLd, vs, P::kLd, sdp,
                               kLdS);
    __syncwarp();
    for (int e = lane; e < kRows * kTile; e += 32) {
      const int rr = e / kTile, c = e % kTile, row = r0 + rr;
      const int kpos = k0 + c;
      float d = 0.0f;  // masked scores: P = exp(-1e30 - lse) = 0
      if (kpos < s.Tk && !(s.causal && kpos > q0 + row)) {
        const float p = expf(ss[rr * kLdS + c] * s.scale - row_lse[row]);
        d = p * (sdp[rr * kLdS + c] - row_delta[row]) * s.scale;
      }
      dss[row * P::kLdP + c] = from_f32<T>(d);
    }
    __syncwarp();
    warp_gemm<kD, kTile, false>(dss + r0 * P::kLdP, P::kLdP, ks, P::kLd, ss,
                                P::kLdO);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < Acc<kD>::kN; ++i) {
      const int e = lane + 32 * i;
      acc.v[i] += ss[(e / kD) * P::kLdO + e % kD];
    }
  }
  store_rows<T, kD>(dq, acc, b, h, q0, s.T, s);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv(View q, View k, View v, View dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, Dims s) {
  using P = DkvPlan<T, kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = P::tile(smem, 0);
  T* vs = P::tile(smem, 1);
  T* qs = P::tile(smem, 2);
  T* dos = P::tile(smem, 3);
  T* pts = P::ptile(smem, 0);  // P^T: rows are keys, columns queries
  T* dsts = P::ptile(smem, 1);  // dS^T
  float* row_lse = P::vec(smem, 0);  // by query
  float* row_delta = P::vec(smem, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* ss = P::scratch(smem, warp);  // S^T | dP^T, then a product
  float* sdp = ss + kRows * kLdS;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<T, kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
  load_tile<T, kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
  Acc<kD> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  const int nq = (s.T + kTile - 1) / kTile;
  // causal: query tiles entirely above this key tile see none of its keys
  const int qt0 = s.causal ? k0 / kTile : 0;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
    load_tile<T, kD>(dos, P::kLd, dout, b, h, q0, s.T, s.D);
    load_rows(row_lse, row_delta, lse, delta, bh, q0, s.T);
    __syncthreads();
    warp_gemm<kTile, kD, true>(ks + r0 * P::kLd, P::kLd, qs, P::kLd, ss,
                               kLdS);
    warp_gemm<kTile, kD, true>(vs + r0 * P::kLd, P::kLd, dos, P::kLd, sdp,
                               kLdS);
    __syncwarp();
    for (int e = lane; e < kRows * kTile; e += 32) {
      const int rr = e / kTile, c = e % kTile, key = r0 + rr;
      const int kpos = k0 + key, qpos = q0 + c;
      float p = 0.0f, d = 0.0f;
      if (qpos < s.T && kpos < s.Tk && !(s.causal && kpos > qpos)) {
        p = expf(ss[rr * kLdS + c] * s.scale - row_lse[c]);
        d = p * (sdp[rr * kLdS + c] - row_delta[c]) * s.scale;
      }
      pts[key * P::kLdP + c] = from_f32<T>(p);
      dsts[key * P::kLdP + c] = from_f32<T>(d);
    }
    __syncwarp();
    warp_gemm<kD, kTile, false>(pts + r0 * P::kLdP, P::kLdP, dos, P::kLd, ss,
                                P::kLdO);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < Acc<kD>::kN; ++i) {
      const int e = lane + 32 * i;
      dv_acc.v[i] += ss[(e / kD) * P::kLdO + e % kD];
    }
    __syncwarp();
    warp_gemm<kD, kTile, false>(dsts + r0 * P::kLdP, P::kLdP, qs, P::kLd, ss,
                                P::kLdO);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < Acc<kD>::kN; ++i) {
      const int e = lane + 32 * i;
      dk_acc.v[i] += ss[(e / kD) * P::kLdO + e % kD];
    }
  }
  store_rows<T, kD>(dk, dk_acc, b, h, k0, s.Tk, s);
  store_rows<T, kD>(dv, dv_acc, b, h, k0, s.Tk, s);
}

View view(const void* p, const long long* strides) {
  return View{p, strides[0], strides[1], strides[2]};
}

// Launches `kernel` over (tiles of `rows`, B * H) with the plan's dynamic
// shared memory; returns the cudaError_t of the attribute call or launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int rows, const Dims& d,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTile - 1) / kTile, d.B * d.H);
  kernel<<<grid, kThreads, smem, stream>>>(args..., d);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t fwd(const long long* st, const void* q, const void* k,
                const void* v, void* out, float* lse, const Dims& d,
                cudaStream_t s) {
  return launch(flash_fwd<T, kD>, FwdPlan<T, kD>::kBytes, d.T, d, s,
                view(q, st), view(k, st + 3), view(v, st + 6),
                static_cast<T*>(out), lse);
}

template <typename T, int kD>
cudaError_t dq(const long long* st, const void* q, const void* k,
               const void* v, const void* dout, const float* lse,
               const float* delta, void* dq_out, const Dims& d,
               cudaStream_t s) {
  return launch(flash_dq<T, kD>, DqPlan<T, kD>::kBytes, d.T, d, s,
                view(q, st), view(k, st + 3), view(v, st + 6),
                view(dout, st + 9), lse, delta, static_cast<T*>(dq_out));
}

template <typename T, int kD>
cudaError_t dkv(const long long* st, const void* q, const void* k,
                const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, const Dims& d,
                cudaStream_t s) {
  return launch(flash_dkv<T, kD>, DkvPlan<T, kD>::kBytes, d.Tk, d, s,
                view(q, st), view(k, st + 3), view(v, st + 6),
                view(dout, st + 9), lse, delta, static_cast<T*>(dk),
                static_cast<T*>(dv));
}

// The kernels' head dim: D rounded up to 32, 64 or 128.
int padded(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

#define DVT_FLASH_DISPATCH(FN, ...)                                       \
  do {                                                                    \
    const int kd = padded(D);                                             \
    if (dtype == 1) {                                                     \
      err = kd == 32    ? FN<bf16, 32>(__VA_ARGS__)                       \
            : kd == 64  ? FN<bf16, 64>(__VA_ARGS__)                       \
                        : FN<bf16, 128>(__VA_ARGS__);                     \
    } else {                                                              \
      err = kd == 32    ? FN<float, 32>(__VA_ARGS__)                      \
            : kd == 64  ? FN<float, 64>(__VA_ARGS__)                      \
                        : FN<float, 128>(__VA_ARGS__);                    \
    }                                                                     \
  } while (0)

}  // namespace

// Shapes and strides shared by the three entry points: q (B, T, H, D), k and
// v (B, Tk, H, D), dout like q, each given by the (batch, token, head)
// element strides in `strides` (q, k, v[, dout] in that order; stride 1 on
// D); every view 16-byte aligned with strides that keep its rows so. D is a
// multiple of 8 no larger than 128, dtype 0 = f32, 1 = bf16 (all tensors
// alike), B * H at most 65535, T and Tk at least 1. Each launches on
// `stream` without synchronising and returns the cudaError_t.

// out (B, T, H, D) contiguous, lse (B, H, T) f32 or null (not written).
extern "C" int dvt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int T, int Tk, int D, float scale,
                             int causal, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{B, H, T, Tk, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVT_FLASH_DISPATCH(fwd, strides, q, k, v, out, static_cast<float*>(lse), d,
                     s);
  return static_cast<int>(err);
}

// dq (B, T, H, D) contiguous from lse and delta (B, H, T) f32.
extern "C" int dvt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_out,
                            const long long* strides, int B, int H, int T,
                            int Tk, int D, float scale, int causal, int dtype,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{B, H, T, Tk, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVT_FLASH_DISPATCH(dq, strides, q, k, v, dout,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dq_out, d, s);
  return static_cast<int>(err);
}

// dk, dv (B, Tk, H, D) contiguous from lse and delta (B, H, T) f32.
extern "C" int dvt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int T,
                             int Tk, int D, float scale, int causal,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{B, H, T, Tk, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVT_FLASH_DISPATCH(dkv, strides, q, k, v, dout,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dk, dv, d, s);
  return static_cast<int>(err);
}
