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
// f32 (the TPU's (B*H, T, 128) lane broadcast is a tiling artefact). Any T
// and Tk are taken without padding in memory (keys beyond Tk take no part in
// the softmax, queries beyond T are not written), and D is any multiple of 8
// up to 128, computed at the next of 32, 64, 128.
//
// What bounds it. At the ViT-S/16 512 step (B 64, T 1024, H 6, D 64, bf16)
// the work is 2 (forward), 3 (dq) or 4 (dkv) products of 2*T*T*D flops per
// head against ~200 MB of inputs: far above the H100's ~295 flops per byte,
// so the bound is the tensor cores, with the T*T exponentials on the SFUs
// nearly as long (0.096 against 0.104 ms in the forward).
//
// Two designs live here.
//
// bf16: the Hopper design (flash_fwd_sm90, flash_dq_sm90, flash_dkv_sm90).
// - A CTA is consumer warpgroups and one producer warp. The forward and
//   dq CTAs own 128 query rows of one (b, h), 64 for each of two
//   warpgroups, and walk key tiles: 128 keys in the forward (64 at
//   D = 128), 64 in dq (32 at D = 128, where dQ takes 64 registers). The
//   dK/dV CTA owns 128 keys, 64 for each of two warpgroups (64 keys and
//   one warpgroup at D = 128, where dK and dV take 64 registers each: a
//   CTA of 160 threads may give a thread 255), holds its K and V tiles in
//   shared memory for its whole life and walks query tiles of 64 (32 at
//   D = 128). The dq CTA likewise holds Q and dO.
// - Tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over (D, H, T, B)
//   built on the host per call from the views' strides, so strided views are
//   read in place; no view needs cp.async) into a ring of kStages stages
//   (4 in dq) guarded by mbarriers: the producer warp waits for a free stage and
//   issues the next tile's copies while the consumers compute on the
//   current one. TMA zero-fills rows past T or Tk and columns past D;
//   shared tiles carry TMA's 128-byte swizzle (64-byte at D = 32), in
//   column blocks of 64 elements at D = 128.
// - Products are wgmma.mma_async m64nNk16 bf16 -> f32. S = Q K^T (and
//   dP = dO V^T in dq; S^T = K Q^T and dP^T = V dO^T in dkv) read both
//   operands from shared memory through K-major descriptors and stay in
//   registers. P (dS in dq, P^T and dS^T in dkv) is rounded to bf16 in
//   registers, where wgmma's accumulator layout is its A fragment layout,
//   and enters O += P V (dQ += dS K; dV += P^T dO, dK += dS^T Q) as the
//   register A operand against an MN-major (transposed) shared B operand:
//   dq reads the same K tile twice, K-major for S and MN-major for dQ.
// - The softmax runs on each thread's own fragment rows: a row's max and sum
//   reduce over the four threads of a quad with two shuffles; scores enter
//   exp2 as one FFMA, s * (scale log2 e) - m2, and one ex2.approx; the
//   rescale factor multiplies the O accumulators in registers. lse is
//   written in natural log, (m2 + log2 max(l, 1e-20)) ln 2. The backward
//   knows lse: P = exp2(s * (scale log2 e) - lse log2 e) needs no
//   reduction, and dq keeps lse log2 e and delta of its two fragment rows
//   in registers.
// - Masks are applied only on the tiles that need them: the ragged last key
//   tile (keys >= Tk set to -inf in the forward, P = 0 in dq: TMA's zero
//   rows would give score 0), the causal diagonal tiles, and in dkv the
//   ragged last query tile (P = 0 for queries >= T). Query rows >= T
//   score 0 against lse 0 and delta 0 in dq, so dS = 0 there; they are
//   not stored. Under causal masking the key loop ends at the tile of the
//   CTA's last valid row (in dq, of the warpgroup's).
// - dQ, dK and dV accumulate in registers over the whole loop and are
//   stored once: no atomics, repeatable bits. dq folds the softmax scale
//   into that store (dS is rounded to bf16 unscaled).
// - The forward and dq are software-pipelined inside each warpgroup: the
//   scores of tile j (S_j, and dP_j in dq) are issued together with the
//   second product of tile j - 1, and the exponentials of tile j run on
//   the CUDA cores and SFUs while that product is on the tensor cores; a
//   ring stage is released once the product reading it has landed.
// What is left for later: the two warpgroups are not ordered against each
// other (a ping-pong of one's exponentials against the other's products
// on named barriers gave no gain in the forward or in dq), dK/dV is not
// pipelined across query tiles, S and dP in dq are shared-memory products
// at N = 64 (Q and dO as register fragments would halve what they read),
// and outputs are stored from registers rather than through shared
// memory and TMA.
//
// float32: the first design (flash_fwd, flash_dq, flash_dkv). One CTA of 4
// warps per 64-row tile (64 keys in dkv), looping over the other axis;
// tiles loaded synchronously with 16-byte accesses; each warp owns 16 rows
// and multiplies on the CUDA cores in full precision: wgmma takes f32 only
// as TF32, which would break the card-vs-CPU float32 check of the ViT step.
//
// Numerics. Products of bf16 values are exact in f32, so S and dP match the
// TPU kernel's f32 dots up to summation order; P and dS are rounded to bf16
// to enter the second products, where the TPU kernel keeps them in f32: a
// relative error of at most 2^-9 per term.
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap's types; the encoder comes via the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // query rows and key columns per tile
constexpr int kWarps = 4;
// threads a CTA; the kernels' launch bounds also ask for just one CTA an
// SM, so ptxas keeps their accumulators in registers (given only the
// thread count it trimmed registers toward more resident CTAs, which
// their 80-205 KB of shared memory does not allow, and spilled them)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;  // tile rows per warp
constexpr int kLdS = kTile + 4;        // f32 score tiles
// f32 elements of padding per shared-memory row: 16 bytes, which keeps rows
// 16-byte aligned for the loads
constexpr int kPad = 4;
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

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
template <int kD>
__device__ void load_tile(float* dst, int ld, const View& src, int b, int h,
                          int t0, int n, int d) {
  constexpr int kVec = 4;
  constexpr int kChunks = kD / kVec;
  const float* base =
      static_cast<const float*>(src.p) + b * src.sb + h * src.sh;
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

// Shared-memory plan, in floats, shared by the three kernels: kTiles tiles
// of kTile x (kD + kPad), kPTiles of kTile x (kTile + kPad), a per-warp
// scratch (two score tiles of kRows x kLdS, or one kRows x (kD + 4) product,
// which aliases them), then kVecs per-row vectors of kTile.
template <int kD, int kTiles, int kPTiles, int kVecs>
struct Plan {
  static constexpr int kLd = kD + kPad;
  static constexpr int kLdP = kTile + kPad;
  static constexpr int kLdO = kD + 4;
  static constexpr int kScratch =
      (2 * kLdS > kLdO ? 2 * kLdS : kLdO) * kRows;  // floats per warp
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kPFloats = kTile * kLdP;
  static constexpr size_t kBytes =
      sizeof(float) * (kTiles * kTileFloats + kPTiles * kPFloats +
                       kWarps * kScratch + kVecs * kTile);
  __device__ static float* tile(unsigned char* s, int i) {
    return reinterpret_cast<float*>(s) + i * kTileFloats;
  }
  __device__ static float* ptile(unsigned char* s, int i) {
    return tile(s, kTiles) + i * kPFloats;
  }
  __device__ static float* scratch(unsigned char* s, int warp) {
    return ptile(s, kPTiles) + warp * kScratch;
  }
  __device__ static float* vec(unsigned char* s, int i) {
    return scratch(s, kWarps) + i * kTile;
  }
};

template <int kD>
using FwdPlan = Plan<kD, 3, 1, 3>;  // Q K V | P | m l alpha
template <int kD>
using DqPlan = Plan<kD, 4, 1, 2>;   // Q dO K V | dS | lse delta
template <int kD>
using DkvPlan = Plan<kD, 4, 2, 2>;  // K V Q dO | P^T dS^T | lse delta

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

// The float32 forward.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(View q, View k, View v, float* __restrict__ out,
              float* __restrict__ lse, Dims s) {
  using P = FwdPlan<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = P::tile(smem, 0);
  float* ks = P::tile(smem, 1);
  float* vs = P::tile(smem, 2);
  float* ps = P::ptile(smem, 0);
  float* row_m = P::vec(smem, 0);
  float* row_l = P::vec(smem, 1);
  float* row_a = P::vec(smem, 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* sc = P::scratch(smem, warp);  // S, then the P V product
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
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
    load_tile<kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
    load_tile<kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
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
        ps[row * P::kLdP + lane + 32 * j] = p;
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
          acc.v[i] / l;
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

template <int kD>
__device__ void store_rows(float* __restrict__ dst, const Acc<kD>& acc, int b,
                           int h, int t0, int n, const Dims& s) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
#pragma unroll
  for (int i = 0; i < Acc<kD>::kN; ++i) {
    const int e = lane + 32 * i, rr = e / kD, c = e % kD;
    const int t = t0 + r0 + rr;
    if (t < n && c < s.D)
      dst[((static_cast<int64_t>(b) * n + t) * s.H + h) * s.D + c] =
          acc.v[i];
  }
}

// The float32 dq.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq(View q, View k, View v, View dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq,
             Dims s) {
  using P = DqPlan<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = P::tile(smem, 0);
  float* dos = P::tile(smem, 1);
  float* ks = P::tile(smem, 2);
  float* vs = P::tile(smem, 3);
  float* dss = P::ptile(smem, 0);
  float* row_lse = P::vec(smem, 0);
  float* row_delta = P::vec(smem, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* ss = P::scratch(smem, warp);  // S | dP, then the dS K product
  float* sdp = ss + kRows * kLdS;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
  load_tile<kD>(dos, P::kLd, dout, b, h, q0, s.T, s.D);
  load_rows(row_lse, row_delta, lse, delta, bh, q0, s.T);
  Acc<kD> acc;
  acc.zero();
  int nk = (s.Tk + kTile - 1) / kTile;
  if (s.causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
    load_tile<kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
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
      dss[row * P::kLdP + c] = d;
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
  store_rows<kD>(dq, acc, b, h, q0, s.T, s);
}

// The float32 dK/dV.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv(View q, View k, View v, View dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, Dims s) {
  using P = DkvPlan<kD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = P::tile(smem, 0);
  float* vs = P::tile(smem, 1);
  float* qs = P::tile(smem, 2);
  float* dos = P::tile(smem, 3);
  float* pts = P::ptile(smem, 0);  // P^T: rows are keys, columns queries
  float* dsts = P::ptile(smem, 1);  // dS^T
  float* row_lse = P::vec(smem, 0);  // by query
  float* row_delta = P::vec(smem, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;
  float* ss = P::scratch(smem, warp);  // S^T | dP^T, then a product
  float* sdp = ss + kRows * kLdS;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;

  load_tile<kD>(ks, P::kLd, k, b, h, k0, s.Tk, s.D);
  load_tile<kD>(vs, P::kLd, v, b, h, k0, s.Tk, s.D);
  Acc<kD> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  const int nq = (s.T + kTile - 1) / kTile;
  // causal: query tiles entirely above this key tile see none of its keys
  const int qt0 = s.causal ? k0 / kTile : 0;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<kD>(qs, P::kLd, q, b, h, q0, s.T, s.D);
    load_tile<kD>(dos, P::kLd, dout, b, h, q0, s.T, s.D);
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
      pts[key * P::kLdP + c] = p;
      dsts[key * P::kLdP + c] = d;
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
  store_rows<kD>(dk, dk_acc, b, h, k0, s.Tk, s);
  store_rows<kD>(dv, dv_acc, b, h, k0, s.Tk, s);
}

// -- the Hopper design (bf16) ------------------------------------------------

constexpr int kStages = 3;                         // tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared tiles for head dim kD: rows of kSw elements (kSw * 2 bytes, the
// swizzle span), kD / kSw column blocks one after the other, each block of
// n rows a multiple of 1024 bytes so the swizzle pattern is anchored.
template <int kD>
struct Tiles {
  static constexpr int kSw = kD < 64 ? kD : 64;
  static constexpr int kSwBytes = kSw * 2;
  static constexpr int kBlocks = kD / kSw;
  // bytes of a tile of n rows, and of one of its column blocks
  __host__ __device__ static constexpr int bytes(int n) { return n * kD * 2; }
  __host__ __device__ static constexpr int block(int n) {
    return n * kSwBytes;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its previous phase, parity 1, as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (d, h, t, b) of a 4-D (D, H, T, B) map into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by these layouts), stride byte offset `sbo` between 8-row groups,
// and the swizzle mode of a kSwBytes span (128 B: 1, 64 B: 2).
template <int kSwBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t sbo) {
  static_assert(kSwBytes == 128 || kSwBytes == 64, "swizzle span");
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(kSwBytes == 128 ? 1 : 2) << 62;
  return d;
}

// K-major operand: k-step kk (16 elements of the contraction, which runs
// along a row) of a tile of n rows, starting at row r0.
template <int kD>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int n,
                                           int r0, int kk) {
  using L = Tiles<kD>;
  const int col = kk * 16;
  return smem_desc<L::kSwBytes>(tile + (col / L::kSw) * L::block(n) +
                                    r0 * L::kSwBytes + (col % L::kSw) * 2,
                                8 * L::kSwBytes);
}

// MN-major operand: k-step kk (16 rows of the contraction) of column block
// c of a tile of n rows.
template <int kD>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int n,
                                            int c, int kk) {
  using L = Tiles<kD>;
  return smem_desc<L::kSwBytes>(tile + c * L::block(n) + kk * 16 * L::kSwBytes,
                                8 * L::kSwBytes);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// ... and the bf16 A fragments an asynchronous RS product reads
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x N, f32, accumulator layout) = (accumulate ? d : 0) + A B: A from
// shared memory (K-major descriptor da), B from shared memory (K-major, db).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate);
// d += A B: A from registers (bf16 fragment a[4]), B from shared memory
// (MN-major, db).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, "
      "%20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Accumulator layout of m64nN (per warpgroup thread): warp w of the
// warpgroup, lane l hold rows 16 w + l / 4 (index i with (i / 2) % 2 == 0)
// and 16 w + l / 4 + 8 (otherwise), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) { return ((i >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores 64 rows x kD of f32 accumulators as bf16 rows [t0, t0 + 64) of a
// contiguous (B, n, H, D) tensor, times `mul[half]`; rows >= n and columns
// >= D are not written.
template <int kD>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst,
                                          const float (&acc)[kD / 2],
                                          const float (&mul)[2], int b, int h,
                                          int t0, int n, const Dims& s) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + 16 * w + lane / 4 + 8 * half;
    if (t >= n) continue;
    bf16* row = dst + ((static_cast<int64_t>(b) * n + t) * s.H + h) * s.D;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (c < s.D)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] * mul[half],
            acc[4 * j + 2 * half + 1] * mul[half]);
    }
  }
}

template <int kD>
struct FwdSm90 {
  using L = Tiles<kD>;
  static constexpr int kQRows = 128;               // query rows a CTA
  static constexpr int kWarps = 8;                // consumer warps: 2 groups
  static constexpr int kThreads = 32 * kWarps + 32;  // + the producer warp
  // keys a tile (64 at D = 128, where O takes 64 registers)
  static constexpr int kBN = kD == 128 ? 64 : 128;
  static constexpr int kQBytes = L::bytes(kQRows);
  static constexpr int kKVBytes = L::bytes(kBN);  // a K or a V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes;
};

// The bf16 forward: CTA (blockIdx.x: 128 query rows, blockIdx.y: b * H + h).
template <int kD>
__global__ void __launch_bounds__(FwdSm90<kD>::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, float* __restrict__ lse, Dims s) {
  using C = FwdSm90<kD>;
  using L = Tiles<kD>;
  constexpr int kBN = C::kBN, kQRows = C::kQRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + C::kQBytes;  // stage i: K, then V

  const int q0 = blockIdx.x * kQRows;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  int nk = (s.Tk + kBN - 1) / kBN;
  if (s.causal) nk = min(nk, (min(q0 + kQRows, s.T) - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::kWarps);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == C::kWarps) {  // the producer: one thread issues copies
    if (lane == 0) {
      mbar_expect_tx(&qbar, C::kQBytes);
      for (int c = 0; c < L::kBlocks; ++c)
        tma_load(qs + c * L::block(kQRows), &tq, &qbar, c * L::kSw, h, q0,
                 b);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        uint8_t* kt = ring + st * C::kStageBytes;
        for (int c = 0; c < L::kBlocks; ++c) {
          tma_load(kt + c * L::block(kBN), &tk, &full[st], c * L::kSw, h,
                   j * kBN, b);
          tma_load(kt + C::kKVBytes + c * L::block(kBN), &tv, &full[st],
                   c * L::kSw, h, j * kBN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [qw, qw + 64)
  const int wg = warp / 4;
  const int qw = q0 + wg * 64;
  const int row0 = qw + 16 * (warp & 3) + lane / 4;  // and row0 + 8
  const float sl2 = s.scale * kLog2e;
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};  // this thread's part of the running sum
  mbar_wait(&qbar, 0);

  // S_j = Q K_j^T into sc (issued, not waited for)
  float sc[kBN / 2];
  auto issue_s = [&](int j) {
    const uint8_t* kt = ring + (j % kStages) * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<kBN>(sc, kmajor<kD>(qs, kQRows, wg * 64, kk),
                    kmajor<kD>(kt, kBN, 0, kk), kk > 0);
    wg_commit();
  };
  // O += P_j V_j from the bf16 fragments pf (issued, not waited for)
  uint32_t pf[kBN / 4];
  auto issue_pv = [&](int j) {
    const uint8_t* vt =
        ring + (j % kStages) * C::kStageBytes + C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kBlocks; ++c)
        wgmma_rs<L::kSw>(o + c * L::kSw / 2, pf + 4 * kk,
                         mnmajor<kD>(vt, kBN, c, kk));
    wg_commit();
  };
  // the online softmax of S_j, in place: sc becomes P_j (f32), l and m
  // move on, and alpha is what O must be multiplied by before P_j V_j
  float alpha[2];
  auto softmax = [&](int j) {
    const int k0 = j * kBN;
    if (k0 + kBN > s.Tk || (s.causal && k0 + kBN - 1 > qw)) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int key = k0 + acc_col(i, lane), row = row0 + acc_row(i);
        if (key >= s.Tk || (s.causal && key > row)) sc[i] = -CUDART_INF_F;
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
      const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
      alpha[r] = ex2(m[r] - m_use);
      m[r] = m_new;
      neg_m[r] = -m_use;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], sl2, neg_m[r]));
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  };
  auto pack_p = [&] {
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i)
      pf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kStages]);
  };

  // Software pipeline: S_j is issued before P_{j-1} V_{j-1}, and the
  // softmax of S_j runs while that product is on the tensor cores; O is
  // rescaled only once it has landed.
  mbar_wait(&full[0], 0);
  wg_fence();
  issue_s(0);
  wg_wait_all();
  fence_regs(sc);
  softmax(0);  // O is 0: no rescale
  pack_p();
  for (int j = 1; j < nk; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    fence_regs(o);
    wg_fence();
    issue_s(j);
    issue_pv(j - 1);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_regs(sc);
    softmax(j);
    wg_wait_all();
    fence_regs(o);
    release(j - 1);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  fence_regs(o);
  wg_fence();
  issue_pv(nk - 1);
  wg_wait_all();
  fence_regs(o);
  release(nk - 1);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-20f);
    inv[r] = 1.0f / l[r];
  }
  store_acc<kD>(out, o, inv, b, h, qw, s.T, s);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t < s.T)
        lse[static_cast<int64_t>(bh) * s.T + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int kD>
struct DqSm90 {
  using L = Tiles<kD>;
  static constexpr int kQRows = 128;                 // query rows a CTA
  static constexpr int kWarps = 8;                   // consumer warps: 2 groups
  static constexpr int kThreads = 32 * kWarps + 32;  // + the producer warp
  // keys a tile: S and dP (kBN / 2 registers each), dQ (kD / 2) and the
  // packed dS (kBN / 4) stay under the 168 registers a thread of a
  // 288-thread CTA may hold (32 keys at D = 128, where dQ takes 64)
  static constexpr int kBN = kD == 128 ? 32 : 64;
  static constexpr int kStages = 4;  // K/V tiles in flight
  // causal: the first warpgroup may skip up to 64 / kBN last tiles and
  // never release them; the producer waits for none of them
  static_assert(64 / kBN < kStages, "a warpgroup's causal early end");
  static constexpr int kQBytes = L::bytes(kQRows);  // Q, and dO
  static constexpr int kKVBytes = L::bytes(kBN);    // a K or a V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + kStages * kStageBytes;
};

// The bf16 dq: CTA (blockIdx.x: 128 query rows, blockIdx.y: b * H + h).
template <int kD>
__global__ void __launch_bounds__(DqSm90<kD>::kThreads, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  Dims s) {
  using C = DqSm90<kD>;
  using L = Tiles<kD>;
  constexpr int kBN = C::kBN, kQRows = C::kQRows, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* dos = qs + C::kQBytes;
  uint8_t* ring = dos + C::kQBytes;  // stage i: K, then V

  const int q0 = blockIdx.x * kQRows;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  int nk = (s.Tk + kBN - 1) / kBN;
  if (s.causal) nk = min(nk, (min(q0 + kQRows, s.T) - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::kWarps);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == C::kWarps) {  // the producer: one thread issues copies
    if (lane == 0) {
      mbar_expect_tx(&qbar, 2 * C::kQBytes);
      for (int c = 0; c < L::kBlocks; ++c) {
        tma_load(qs + c * L::block(kQRows), &tq, &qbar, c * L::kSw, h, q0,
                 b);
        tma_load(dos + c * L::block(kQRows), &tdo, &qbar, c * L::kSw, h, q0,
                 b);
      }
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        uint8_t* kt = ring + st * C::kStageBytes;
        for (int c = 0; c < L::kBlocks; ++c) {
          tma_load(kt + c * L::block(kBN), &tk, &full[st], c * L::kSw, h,
                   j * kBN, b);
          tma_load(kt + C::kKVBytes + c * L::block(kBN), &tv, &full[st],
                   c * L::kSw, h, j * kBN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [qw, qw + 64)
  const int wg = warp / 4;
  const int qw = q0 + wg * 64;
  const int row0 = qw + 16 * (warp & 3) + lane / 4;  // and row0 + 8
  // causal: the first warpgroup's rows may see none of the CTA's last
  // 64 / kBN tiles
  const int nkw =
      s.causal ? min(nk, (min(qw + 64, s.T) - 1) / kBN + 1) : nk;
  const float sl2 = s.scale * kLog2e;
  // -lse log2 e and delta of this thread's two rows (0 past T: those rows
  // score 0 against zero-filled Q and dO, so dS = 0 there)
  float neg_lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * s.T + t;
    neg_lse2[r] = t < s.T ? -lse[at] * kLog2e : 0.0f;
    dl[r] = t < s.T ? delta[at] : 0.0f;
  }
  float dqa[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dqa[i] = 0.0f;
  mbar_wait(&qbar, 0);

  // S_j = Q K_j^T into sc and dP_j = dO V_j^T into dp (issued, not waited
  // for)
  float sc[kBN / 2], dp[kBN / 2];
  auto issue_sdp = [&](int j) {
    const uint8_t* kt = ring + (j % kStages) * C::kStageBytes;
    const uint8_t* vt = kt + C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<kBN>(sc, kmajor<kD>(qs, kQRows, wg * 64, kk),
                    kmajor<kD>(kt, kBN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<kBN>(dp, kmajor<kD>(dos, kQRows, wg * 64, kk),
                    kmajor<kD>(vt, kBN, 0, kk), kk > 0);
    wg_commit();
  };
  // dQ += dS_j K_j from the bf16 fragments dsf, K_j read MN-major (issued,
  // not waited for)
  uint32_t dsf[kBN / 4];
  auto issue_dq = [&](int j) {
    const uint8_t* kt = ring + (j % kStages) * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kBlocks; ++c)
        wgmma_rs<L::kSw>(dqa + c * L::kSw / 2, dsf + 4 * kk,
                         mnmajor<kD>(kt, kBN, c, kk));
    wg_commit();
  };
  // dS_j / scale = P (dP - delta) in place of S_j (the scale is applied
  // once, to dQ)
  auto dscores = [&](int j) {
    const int k0 = j * kBN;
    const bool masked = k0 + kBN > s.Tk || (s.causal && k0 + kBN - 1 > qw);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], sl2, neg_lse2[r]));
      if (masked) {
        const int key = k0 + acc_col(i, lane), row = row0 + acc_row(i);
        if (key >= s.Tk || (s.causal && key > row)) p = 0.0f;
      }
      sc[i] = p * (dp[i] - dl[r]);
    }
  };
  auto pack_ds = [&] {
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i)
      dsf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kStages]);
  };

  // Software pipeline: S_j and dP_j are issued before dS_{j-1} K_{j-1},
  // and dS_j is computed while that product is on the tensor cores; dsf
  // is overwritten, and the stage of K_{j-1} released, only once it has
  // landed.
  mbar_wait(&full[0], 0);
  wg_fence();
  issue_sdp(0);
  wg_wait_all();
  fence_regs(sc);
  fence_regs(dp);
  dscores(0);
  pack_ds();
  for (int j = 1; j < nkw; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    fence_regs(dqa);
    wg_fence();
    issue_sdp(j);
    issue_dq(j - 1);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_regs(sc);
    fence_regs(dp);
    dscores(j);
    wg_wait_all();
    fence_regs(dqa);
    fence_regs(dsf);
    release(j - 1);
    pack_ds();
  }
  fence_regs(dqa);
  wg_fence();
  issue_dq(nkw - 1);
  wg_wait_all();
  fence_regs(dqa);
  fence_regs(dsf);
  release(nkw - 1);

  const float mul[2] = {s.scale, s.scale};
  store_acc<kD>(dq, dqa, mul, b, h, qw, s.T, s);
}

template <int kD>
struct DkvSm90 {
  using L = Tiles<kD>;
  // at D = 128 dK and dV take 64 registers each: one consumer warpgroup
  // (64 keys) a CTA, whose threads may hold 255 registers, and query tiles
  // of 32, so nothing spills
  static constexpr int kGroups = kD == 128 ? 1 : 2;
  static constexpr int kKeys = 64 * kGroups;      // keys a CTA
  static constexpr int kWarps = 4 * kGroups;      // consumer warps
  static constexpr int kThreads = 32 * kWarps + 32;
  static constexpr int kBN = kD == 128 ? 32 : 64;  // queries a tile
  static constexpr int kKBytes = L::bytes(kKeys);  // K, and V
  static constexpr int kQBytes = L::bytes(kBN);         // Q, and dO
  // a stage: Q, dO, then lse * log2 e and delta of its kBN queries
  static constexpr int kStageBytes =
      (2 * kQBytes + 2 * kBN * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kKBytes + kStages * kStageBytes;
};

// The bf16 dK/dV: CTA (blockIdx.x: kKeys keys, blockIdx.y: b * H + h).
template <int kD>
__global__ void __launch_bounds__(DkvSm90<kD>::kThreads, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Dims s) {
  using C = DkvSm90<kD>;
  using L = Tiles<kD>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kvbar;
  uint8_t* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = ks + C::kKBytes;
  uint8_t* ring = vs + C::kKBytes;  // stage i: Q, dO, lse * log2 e, delta

  const int k0 = blockIdx.x * C::kKeys;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int nq = (s.T + kBN - 1) / kBN;
  // causal: query tiles entirely above the CTA's first key see none of its
  // keys (the reference's _block_visible)
  const int qt0 = s.causal ? min(k0 / kBN, nq) : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1 + 32);  // the copies; each producer lane's rows
      mbar_init(&empty[i], C::kWarps);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == C::kWarps) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * C::kKBytes);
      for (int c = 0; c < L::kBlocks; ++c) {
        tma_load(ks + c * L::block(C::kKeys), &tk, &kvbar, c * L::kSw, h, k0,
                 b);
        tma_load(vs + c * L::block(C::kKeys), &tv, &kvbar, c * L::kSw, h, k0,
                 b);
      }
    }
    for (int it = 0; it < nq - qt0; ++it) {
      const int st = it % kStages, t0 = (qt0 + it) * kBN;
      mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      uint8_t* qt = ring + st * C::kStageBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * C::kQBytes);
        for (int c = 0; c < L::kBlocks; ++c) {
          tma_load(qt + c * L::block(kBN), &tq, &full[st], c * L::kSw, h, t0,
                   b);
          tma_load(qt + C::kQBytes + c * L::block(kBN), &tdo, &full[st],
                   c * L::kSw, h, t0, b);
        }
      }
      float* rows = reinterpret_cast<float*>(qt + 2 * C::kQBytes);
      for (int i = lane; i < kBN; i += 32) {
        const int t = t0 + i;
        const int64_t at = static_cast<int64_t>(bh) * s.T + t;
        rows[i] = t < s.T ? lse[at] * kLog2e : 0.0f;
        rows[kBN + i] = t < s.T ? delta[at] : 0.0f;
      }
      mbar_arrive(&full[st]);
    }
    return;
  }

  // consumers: warpgroup wg owns keys [kw, kw + 64)
  const int wg = warp / 4;
  const int kw = k0 + wg * 64;
  const int key0 = kw + 16 * (warp & 3) + lane / 4;  // and key0 + 8
  const float sl2 = s.scale * kLog2e;
  float dka[kD / 2], dva[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dka[i] = dva[i] = 0.0f;
  mbar_wait(&kvbar, 0);

  for (int it = 0; it < nq - qt0; ++it) {
    const int st = it % kStages, t0 = (qt0 + it) * kBN;
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint8_t* qt = ring + st * C::kStageBytes;
    const uint8_t* dot = qt + C::kQBytes;
    const float* row_lse = reinterpret_cast<const float*>(qt + 2 * C::kQBytes);
    const float* row_delta = row_lse + kBN;

    float sT[kBN / 2], dpT[kBN / 2];  // S^T and dP^T: rows keys, cols queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<kBN>(sT, kmajor<kD>(ks, C::kKeys, wg * 64, kk),
                    kmajor<kD>(qt, kBN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss<kBN>(dpT, kmajor<kD>(vs, C::kKeys, wg * 64, kk),
                    kmajor<kD>(dot, kBN, 0, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sT);
    fence_regs(dpT);

    // keys >= Tk need no mask: their dK and dV rows are not stored
    const bool masked = t0 + kBN > s.T || (s.causal && kw + 63 > t0);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int qc = acc_col(i, lane);
      float p = ex2(fmaf(sT[i], sl2, -row_lse[qc]));
      if (masked) {
        const int t = t0 + qc, key = key0 + acc_row(i);
        if (t >= s.T || (s.causal && key > t)) p = 0.0f;
      }
      sT[i] = p;
      dpT[i] = p * (dpT[i] - row_delta[qc]) * s.scale;
    }
    uint32_t pf[kBN / 4], dsf[kBN / 4];  // P^T and dS^T as A fragments
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      pf[i] = pack_bf16(sT[2 * i], sT[2 * i + 1]);
      dsf[i] = pack_bf16(dpT[2 * i], dpT[2 * i + 1]);
    }

    fence_regs(dva);
    fence_regs(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kBlocks; ++c) {
        wgmma_rs<L::kSw>(dva + c * L::kSw / 2, pf + 4 * kk,
                         mnmajor<kD>(dot, kBN, c, kk));
        wgmma_rs<L::kSw>(dka + c * L::kSw / 2, dsf + 4 * kk,
                         mnmajor<kD>(qt, kBN, c, kk));
      }
    wg_commit();
    wg_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const float one[2] = {1.0f, 1.0f};
  store_acc<kD>(dk, dka, one, b, h, kw, s.Tk, s);
  store_acc<kD>(dv, dva, one, b, h, kw, s.Tk, s);
}

// -- host side ---------------------------------------------------------------

View view(const void* p, const long long* strides) {
  return View{p, strides[0], strides[1], strides[2]};
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: nothing here
// links libcuda. Null when the driver does not offer it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 (B, n, H, D) view with element strides st[0..2] (batch, token,
// head) as a 4-D TMA map over (D, H, n, B) whose box is kSw x 1 x rows x 1,
// swizzled over the kSw * 2-byte span; boxes past n or D read zeros.
template <int kD>
cudaError_t tensor_map(CUtensorMap* map, const void* p, const long long* st,
                       int n, int rows, const Dims& d) {
  using L = Tiles<kD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d.D),
                              static_cast<cuuint64_t>(d.H),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(d.B)};
  const long long elems[3] = {st[2], st[1], st[0]};  // head, token, batch
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    if (elems[i] <= 0 && dims[i + 1] > 1) return cudaErrorInvalidValue;
    // a dimension of size 1 is never stepped: any valid stride will do
    strides[i] = elems[i] > 0 ? static_cast<cuuint64_t>(elems[i]) * 2 : 16;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kSw), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches `kernel` over (tiles of `tile` rows of `rows`, B * H) with
// `threads` threads and `smem` bytes of dynamic shared memory; returns the
// cudaError_t of the attribute call or launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int rows, int tile,
                   int threads, const Dims& d, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + tile - 1) / tile, d.B * d.H);
  kernel<<<grid, threads, smem, stream>>>(args..., d);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t fwd(const long long* st, const void* q, const void* k,
                const void* v, void* out, float* lse, const Dims& d,
                cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap tq, tk, tv;
    cudaError_t err;
    if ((err = tensor_map<kD>(&tq, q, st, d.T, FwdSm90<kD>::kQRows, d)) ||
        (err = tensor_map<kD>(&tk, k, st + 3, d.Tk, FwdSm90<kD>::kBN, d)) ||
        (err = tensor_map<kD>(&tv, v, st + 6, d.Tk, FwdSm90<kD>::kBN, d)))
      return err;
    return launch(flash_fwd_sm90<kD>, FwdSm90<kD>::kSmem, d.T,
                  FwdSm90<kD>::kQRows, FwdSm90<kD>::kThreads, d, s, tq, tk, tv,
                  static_cast<bf16*>(out), lse);
  } else {
    return launch(flash_fwd<kD>, FwdPlan<kD>::kBytes, d.T, kTile, kThreads,
                  d, s, view(q, st), view(k, st + 3), view(v, st + 6),
                  static_cast<float*>(out), lse);
  }
}

template <typename T, int kD>
cudaError_t dq(const long long* st, const void* q, const void* k,
               const void* v, const void* dout, const float* lse,
               const float* delta, void* dq_out, const Dims& d,
               cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    using C = DqSm90<kD>;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t err;
    if ((err = tensor_map<kD>(&tq, q, st, d.T, C::kQRows, d)) ||
        (err = tensor_map<kD>(&tk, k, st + 3, d.Tk, C::kBN, d)) ||
        (err = tensor_map<kD>(&tv, v, st + 6, d.Tk, C::kBN, d)) ||
        (err = tensor_map<kD>(&tdo, dout, st + 9, d.T, C::kQRows, d)))
      return err;
    return launch(flash_dq_sm90<kD>, C::kSmem, d.T, C::kQRows, C::kThreads,
                  d, s, tq, tk, tv, tdo, lse, delta,
                  static_cast<bf16*>(dq_out));
  } else {
    return launch(flash_dq<kD>, DqPlan<kD>::kBytes, d.T, kTile, kThreads, d,
                  s, view(q, st), view(k, st + 3), view(v, st + 6),
                  view(dout, st + 9), lse, delta,
                  static_cast<float*>(dq_out));
  }
}

template <typename T, int kD>
cudaError_t dkv(const long long* st, const void* q, const void* k,
                const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, const Dims& d,
                cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kBN = DkvSm90<kD>::kBN;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t err;
    if ((err = tensor_map<kD>(&tq, q, st, d.T, kBN, d)) ||
        (err = tensor_map<kD>(&tk, k, st + 3, d.Tk, DkvSm90<kD>::kKeys,
                              d)) ||
        (err = tensor_map<kD>(&tv, v, st + 6, d.Tk, DkvSm90<kD>::kKeys,
                              d)) ||
        (err = tensor_map<kD>(&tdo, dout, st + 9, d.T, kBN, d)))
      return err;
    return launch(flash_dkv_sm90<kD>, DkvSm90<kD>::kSmem, d.Tk,
                  DkvSm90<kD>::kKeys, DkvSm90<kD>::kThreads, d, s, tq, tk,
                  tv, tdo, lse, delta,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  } else {
    return launch(flash_dkv<kD>, DkvPlan<kD>::kBytes, d.Tk, kTile, kThreads,
                  d, s, view(q, st), view(k, st + 3), view(v, st + 6),
                  view(dout, st + 9), lse, delta, static_cast<float*>(dk),
                  static_cast<float*>(dv));
  }
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
