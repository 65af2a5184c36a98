// Greedy non-maximum suppression for Hopper (sm_90a): sorted candidates, an
// IoU bitmask built by all SMs, and a chunked warp scan.
//
// Replaces the TPU kernel `_nms_kernel` launched by `pallas_nms`
// (deep_vision_tpu/ops/pallas/nms.py:42, call at :113) and computes what it
// computes, bit for bit: scores below `score_thr` become -1; each of the D
// rounds takes the largest live score (the lowest index on ties), keeps it
// only if it is > 0, and suppresses every live candidate whose IoU with it
// is >= `iou_thr`, and the pick itself. IoU clips sides at 0 and floors the
// union at 1e-9, in the reference's order: inter = iw * ih; union =
// (area_cand + area_pick) - inter. min, max and the clips propagate NaN, as
// torch.minimum / clamp and jnp.minimum do (PTX min.NaN / max.NaN; fminf
// would return the operand that is not NaN). The build uses --fmad=false and
// IEEE division: a contracted multiply-add or an approximate quotient would
// round differently and flip `iou >= thr` against the plain version.
//
// Why a sorted scan is the same function. Greedy arg-max NMS is one walk
// over the candidates {j : s_j >= score_thr and s_j > 0} (NaN scores fail
// both) in the order score descending, index ascending, keeping each one no
// earlier keep has suppressed: a score in [score_thr, 0] is never kept and
// never suppresses, and a kept candidate only ever suppresses later ones.
//
// Two launches, enqueued by one call on the caller's stream, no host sync:
//   nms_compact  one 1024-thread block per image: the candidates' indices
//                and scores in index order (ballots and one block scan per
//                8 K scores), the candidate count M, the outputs set to
//                (0, -1);
//   nms_select   one cooperative grid (two 256-thread blocks an SM), its
//                phases separated by grid-wide barriers:
//     sort       jobs of 64 candidates: rank = the number of candidates
//                that beat each one (larger score, or equal score and lower
//                index; four threads a candidate, every fourth of the others
//                each) -- a counting sort, stable by construction -- then
//                index, score and box (float4) scattered into sorted order,
//                so the mask reads boxes coalesced;
//     per pass of the next K_p sorted candidates (K_p = 512, 1024, ... up
//     to K <= 4096, as the caller sets them, so an image that reaches D
//     keeps early pays for a small mask; the grid leaves the loop once
//     every image is done):
//     mask       jobs of (64-row tile, 64-column word) over the upper
//                triangle, four threads a row, 16 columns each: bit t of
//                word w of row i is set when iou(box_{64w+t}, box_i) >= thr,
//                i < 64w + t; and jobs of 64 columns: the bits that the
//                keeps of earlier passes already suppress (keeps x K_p IoUs);
//     scan       one warp per image walks the pass 64 candidates at a time.
//                A chunk's `removed` word is its earlier-pass bits ORed with
//                the pass's kept rows' words for the chunk (the lanes load
//                them in parallel, one L2 round trip, then reduce). Then the
//                set bits of ~removed & valid, in order: a step takes every
//                live row up to f, the first live row whose diagonal word
//                (prefetched a chunk ahead) hits a live later row -- the
//                rows before f suppress nobody live -- and clears f's word
//                (__ffsll, two ballots, one shuffle). It stops at D keeps
//                and records the image's keeps and whether it is done.
//
// What bounds it. The bytes are ~0.2 MB an image and the IoUs ~K_p^2 / 2 a
// pass, neither near the card's limits at serving sizes (M ~ 1,800). The
// serial part is the scan, one step per keep that suppresses a live later
// candidate and one L2 round trip per chunk, and the grid barriers (one
// after the sort, two a pass). The sort is M^2 comparisons: microseconds at
// M ~ 1,800, milliseconds at M ~ 70,000 (where a radix sort would be the
// next step).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kWord = 64;
constexpr int kMaxPass = 4096;               // K: candidates a mask covers
constexpr int kMaxWords = kMaxPass / kWord;  // 64 mask words per row
constexpr int kCompactThreads = 1024;
constexpr int kCompactTiles = 8;             // 1024-score tiles per scan
constexpr int kThreads = 256;                // nms_select
constexpr int kSplit = kThreads / kWord;     // threads per row / candidate
constexpr int kBlocksPerSm = 2;
constexpr int kSortStage = 8 * kThreads;     // scores a sort stage holds

struct State {
  int m;      // candidates of the image
  int keeps;  // output slots filled so far
  int done;   // D keeps reached or every candidate scanned
  int pad;
};

struct Args {
  const float4* boxes;      // (B, N) input
  int* cand_idx;            // (B, N) from nms_compact
  float* cand_score;        // (B, N) from nms_compact
  // written and read inside nms_select by different blocks: read through
  // L2 (__ldcg), never a stale L1 line
  State* state;             // (B)
  int* sorted_idx;          // (B, N)
  float* sorted_score;      // (B, N)
  float4* sorted_box;       // (B, N)
  u64* pre;                 // (B, 64) earlier passes' bits of a pass's words
  u64* mask;                // (B, K^2 / 64); a pass's words word-major,
                            // [word][row], K_p rows a word
  float* out_s;             // (B, D)
  int* out_i;               // (B, D)
  int batch, n, d, k_first, k_max;  // pass sizes: k_first, doubling to k_max
  float iou_thr;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float box_area(float4 b) {
  return max_nan(b.z - b.x, 0.0f) * max_nan(b.w - b.y, 0.0f);
}

// iou(cand, pick) >= thr, in the plain version's operand order
__device__ __forceinline__ bool suppressed(float4 c, float c_area, float4 p,
                                           float p_area, float thr) {
  const float iw = max_nan(min_nan(c.z, p.z) - max_nan(c.x, p.x), 0.0f);
  const float ih = max_nan(min_nan(c.w, p.w) - max_nan(c.y, p.y), 0.0f);
  const float inter = iw * ih;
  const float iou = inter / max_nan(c_area + p_area - inter, 1e-9f);
  return iou >= thr;
}

__device__ __forceinline__ State load_state(const State* s) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(s));
  return State{v.x, v.y, v.z, v.w};
}

__global__ void __launch_bounds__(kCompactThreads)
nms_compact(const float* __restrict__ scores, int n, int d, float score_thr,
            int* __restrict__ cand_idx, float* __restrict__ cand_score,
            State* __restrict__ state, float* __restrict__ out_s,
            int* __restrict__ out_i) {
  __shared__ int s_off[kCompactTiles][32];
  __shared__ int s_base;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* sc = scores + static_cast<size_t>(b) * n;
  int* ci = cand_idx + static_cast<size_t>(b) * n;
  float* cs = cand_score + static_cast<size_t>(b) * n;
  for (int k = tid; k < d; k += kCompactThreads) {
    out_s[static_cast<size_t>(b) * d + k] = 0.0f;
    out_i[static_cast<size_t>(b) * d + k] = -1;
  }
  if (tid == 0) s_base = 0;
  const unsigned lower = (1u << lane) - 1u;
  for (int g = 0; g < n; g += kCompactTiles * kCompactThreads) {
    float v[kCompactTiles];
    unsigned ballot[kCompactTiles];
#pragma unroll
    for (int t = 0; t < kCompactTiles; ++t) {
      const int j = g + t * kCompactThreads + tid;
      v[t] = j < n ? sc[j] : 0.0f;  // 0 is no candidate
    }
#pragma unroll
    for (int t = 0; t < kCompactTiles; ++t) {
      ballot[t] = __ballot_sync(0xffffffffu, v[t] >= score_thr && v[t] > 0.0f);
      if (lane == 0) s_off[t][warp] = __popc(ballot[t]);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the 8 x 32 warp counts in (tile, warp) order,
      // which is index order: lane l takes entries 8l .. 8l + 7
      int* flat = &s_off[0][0];
      int mine[kCompactTiles], sum = 0;
#pragma unroll
      for (int e = 0; e < kCompactTiles; ++e) {
        mine[e] = sum;
        sum += flat[lane * kCompactTiles + e];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const int base = s_base + incl - sum;
#pragma unroll
      for (int e = 0; e < kCompactTiles; ++e)
        flat[lane * kCompactTiles + e] = base + mine[e];
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      if (lane == 0) s_base += total;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kCompactTiles; ++t) {
      if (ballot[t] >> lane & 1u) {
        const int pos = s_off[t][warp] + __popc(ballot[t] & lower);
        ci[pos] = g + t * kCompactThreads + tid;
        cs[pos] = v[t];
      }
    }
    __syncthreads();
  }
  if (tid == 0) state[b] = State{s_base, 0, s_base == 0 ? 1 : 0, 0};
}

struct Smem {
  float stage[kSortStage];       // sort: a stage of scores
  int part[kSplit][kWord];       // sort: partial ranks
  float4 col[kWord];             // mask: a word's column boxes
  float col_area[kWord];
  bool gone[kThreads];           // mask: earlier-pass suppression
  unsigned half[2];
  int kept[kMaxPass];            // scan: the pass's kept rows
};

// sort: candidates 64 * tile .. of image `img` (m of them in all)
__device__ void sort_job(const Args& a, Smem& sm, int img, int tile, int m) {
  const int tid = threadIdx.x;
  const int c = tid % kWord, q = tid / kWord;
  const size_t row = static_cast<size_t>(img) * a.n;
  const int i = tile * kWord + c;
  const float si = i < m ? a.cand_score[row + i] : 0.0f;
  const int idx = i < m ? a.cand_idx[row + i] : 0;
  int rank = 0;
  for (int t0 = 0; t0 < m; t0 += kSortStage) {
    __syncthreads();
    float v[kSortStage / kThreads];  // loaded together, one latency
#pragma unroll
    for (int e = 0; e < kSortStage / kThreads; ++e) {
      const int j = t0 + e * kThreads + tid;
      v[e] = j < m ? a.cand_score[row + j] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kSortStage / kThreads; ++e)
      sm.stage[e * kThreads + tid] = v[e];
    __syncthreads();
    // thread (c, q) takes the stage's entries q, q + 4, ...: j = t0 + k;
    // those of a lower index (k < lower) beat it on a tie
    const int len = min(kSortStage, m - t0);
    const int lower = max(0, min(i - t0, len));
    int k = q;
#pragma unroll 8
    for (; k < lower; k += kSplit) rank += sm.stage[k] >= si;
#pragma unroll 8
    for (; k < len; k += kSplit) rank += sm.stage[k] > si;
  }
  sm.part[q][c] = rank;
  __syncthreads();
  if (q == 0 && i < m) {
    rank = sm.part[0][c] + sm.part[1][c] + sm.part[2][c] + sm.part[3][c];
    a.sorted_idx[row + rank] = idx;
    a.sorted_score[row + rank] = si;
    a.sorted_box[row + rank] = a.boxes[row + idx];
  }
  __syncthreads();
}

// mask: job q of image `img`'s pass [base, base + kp) of a K_p-wide layout
__device__ void mask_job(const Args& a, Smem& sm, int img, int q, int base,
                         int kpass, int kp, int keeps) {
  const int tid = threadIdx.x;
  const int tq = kpass / kWord;                 // words of the layout
  const int tiles = (kp + kWord - 1) / kWord;   // words of this image
  const float4* sb = a.sorted_box + static_cast<size_t>(img) * a.n + base;
  if (q < tq * tq) {
    const int rt = q / tq, cw = q % tq;
    if (rt >= tiles || cw >= tiles || cw < rt) return;  // uniform
    u64* mk =
        a.mask + static_cast<size_t>(img) * a.k_max * (a.k_max / kWord);
    const int r = tid % kWord, part = tid / kWord;
    const int i = rt * kWord + r;
    const float4 p = i < kp ? __ldcg(sb + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < kWord) {
      const int j = cw * kWord + tid;
      const float4 c =
          j < kp ? __ldcg(sb + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      sm.col[tid] = c;
      sm.col_area[tid] = box_area(c);
    }
    __syncthreads();
    if (i < kp) {
      const float pa = box_area(p);
      const int lo = part * (kWord / kSplit);
      const int hi = min(lo + kWord / kSplit, kp - cw * kWord);
      unsigned bits = 0;
      for (int t = cw == rt ? max(lo, r + 1) : lo; t < hi; ++t)
        if (suppressed(sm.col[t], sm.col_area[t], p, pa, a.iou_thr))
          bits |= 1u << (t - lo);
      // 16 bits of the little-endian 64-bit word (cw, i)
      reinterpret_cast<unsigned short*>(mk)[
          (static_cast<size_t>(cw) * kpass + i) * kSplit + part] =
          static_cast<unsigned short>(bits);
    }
    __syncthreads();
  } else {
    const int w = q - tq * tq;
    if (w >= tiles || keeps == 0) return;  // uniform; the scan reads no
                                           // earlier-pass word then
    const int c = tid % kWord, part = tid / kWord;
    const int j = w * kWord + c;
    bool gone = false;
    if (j < kp && keeps > 0) {
      const float4 cb = __ldcg(sb + j);
      const float ca = box_area(cb);
      const size_t orow = static_cast<size_t>(img) * a.d;
      for (int k = part; k < keeps && !gone; k += kSplit) {
        const float4 p = a.boxes[static_cast<size_t>(img) * a.n +
                                 __ldcg(a.out_i + orow + k)];
        gone = suppressed(cb, ca, p, box_area(p), a.iou_thr);
      }
    }
    sm.gone[tid] = gone;
    __syncthreads();
    if (tid < kWord) {
      bool any = false;
#pragma unroll
      for (int s = 0; s < kSplit; ++s) any |= sm.gone[s * kWord + tid];
      const unsigned half = __ballot_sync(0xffffffffu, any);
      if ((tid & 31) == 0) sm.half[tid >> 5] = half;
    }
    __syncthreads();
    if (tid == 0)
      a.pre[static_cast<size_t>(img) * kMaxWords + w] =
          sm.half[0] | static_cast<u64>(sm.half[1]) << 32;
    __syncthreads();
  }
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  return static_cast<u64>(hi) << 32 | lo;
}

// scan: image `img`'s pass [base, base + kp), one warp
__device__ void scan_image(const Args& a, Smem& sm, int img, int base,
                           int kpass, State st) {
  const int lane = threadIdx.x;
  const int kp = min(kpass, st.m - base);
  const int tiles = (kp + kWord - 1) / kWord;
  const u64* mk =
      a.mask + static_cast<size_t>(img) * a.k_max * (a.k_max / kWord);
  const u64* pw = a.pre + static_cast<size_t>(img) * kMaxWords;
  const size_t row0 = static_cast<size_t>(img) * a.n + base;
  // a chunk's rows lane and lane + 32: diagonal words, scores, indices
  struct Rows {
    u64 word[2];
    float score[2];
    int idx[2];
  };
  auto rows_of = [&](int c) {
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = c * kWord + lane + 32 * h;
      const bool in = c < tiles && i < kp;
      r.word[h] = in ? __ldcg(mk + static_cast<size_t>(c) * kpass + i) : 0ull;
      r.score[h] = in ? __ldcg(a.sorted_score + row0 + i) : 0.0f;
      r.idx[h] = in ? __ldcg(a.sorted_idx + row0 + i) : 0;
    }
    return r;
  };
  Rows cur = rows_of(0);
  int keeps = st.keeps, in_pass = 0;
  for (int c = 0; c < tiles && keeps < a.d; ++c) {
    const Rows next = rows_of(c + 1);
    // the chunk's suppressed bits: earlier passes', then this pass's keeps'
    u64 acc = lane == 0 && st.keeps > 0 ? __ldcg(pw + c) : 0ull;
    for (int r = lane; r < in_pass; r += 32)
      acc |= __ldcg(mk + static_cast<size_t>(c) * kpass + sm.kept[r]);
    const int rows = min(kWord, kp - c * kWord);
    const u64 valid = rows == kWord ? ~0ull : (1ull << rows) - 1ull;
    u64 live = valid & ~warp_or(acc);
    u64 kept = 0ull;
    const int first = keeps;
    // Greedy over the chunk, many keeps a step: the live rows before f,
    // the first live row that suppresses a live later row, suppress no
    // live row, so they and f are all kept; then f's word is applied.
    while (live && keeps < a.d) {  // uniform: every lane holds the same word
      const bool c0 = (live >> lane & 1ull) && (cur.word[0] & live);
      const bool c1 = (live >> (lane + 32) & 1ull) && (cur.word[1] & live);
      const u64 conflict =
          static_cast<u64>(__ballot_sync(0xffffffffu, c1)) << 32 |
          __ballot_sync(0xffffffffu, c0);
      const int f = __ffsll(static_cast<long long>(conflict)) - 1;  // or -1
      u64 take = f < 0 ? live : live & ((2ull << f) - 1ull);
      while (__popcll(take) > a.d - keeps)  // the D-th keep comes first
        take &= ~(1ull << (63 - __clzll(static_cast<long long>(take))));
      const u64 word = __shfl_sync(
          0xffffffffu, (f & 63) < 32 ? cur.word[0] : cur.word[1], f & 31);
      kept |= take;
      keeps += __popcll(take);
      live &= ~take;
      if (f >= 0 && (take >> f & 1ull)) live &= ~word;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (kept >> r & 1ull) {
        const int before = __popcll(kept & ((1ull << r) - 1ull));
        const size_t slot = static_cast<size_t>(img) * a.d + first + before;
        a.out_s[slot] = cur.score[h];
        a.out_i[slot] = cur.idx[h];
        sm.kept[in_pass + before] = c * kWord + r;
      }
    }
    in_pass += __popcll(kept);
    __syncwarp();
    cur = next;
  }
  if (lane == 0) {
    a.state[img].keeps = keeps;
    a.state[img].done = keeps >= a.d || base + kp >= st.m;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
nms_select(Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  // jobs go image-minor (job = q * batch + img), so a block whose stride
  // is a multiple of the batch stays on one image: its state is loaded once
  int img_of_state = -1;
  State st{};
  auto state_of = [&](int img) -> const State& {
    if (img != img_of_state) {
      st = load_state(a.state + img);
      img_of_state = img;
    }
    return st;
  };
  const int nt = (a.n + kWord - 1) / kWord;
  for (int job = blockIdx.x; job < a.batch * nt; job += gridDim.x) {
    const int img = job % a.batch, tile = job / a.batch;
    const int m = state_of(img).m;
    if (tile * kWord < m) sort_job(a, sm, img, tile, m);  // uniform
  }
  grid.sync();
  int kpass = a.k_first;
  for (int base = 0; base < a.n; base += kpass,
           kpass = min(2 * kpass, a.k_max)) {
    bool active = false;  // the same answer in every block
    for (int img = threadIdx.x; img < a.batch; img += kThreads) {
      const State s = load_state(a.state + img);
      active |= !s.done && base < s.m;
    }
    if (!__syncthreads_or(active)) break;
    img_of_state = -1;  // the last pass's scans changed the states
    const int tq = kpass / kWord, per_image = tq * tq + tq;
    for (int job = blockIdx.x; job < a.batch * per_image; job += gridDim.x) {
      const int img = job % a.batch;
      const State& s = state_of(img);
      if (!s.done && base < s.m)  // uniform
        mask_job(a, sm, img, job / a.batch, base, kpass,
                 min(kpass, s.m - base), s.keeps);
    }
    grid.sync();
    if (threadIdx.x < 32) {
      for (int img = blockIdx.x; img < a.batch; img += gridDim.x) {
        const State s = load_state(a.state + img);
        if (!s.done && base < s.m) scan_image(a, sm, img, base, kpass, s);
      }
    }
    grid.sync();
  }
}

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// carves the workspace: p == nullptr counts its bytes only
size_t carve(char* p, int batch, int n, int k_max, Args* a) {
  const size_t bn = static_cast<size_t>(batch) * n;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = p ? p + off : nullptr;
    off += align16(bytes);
    return at;
  };
  State* state = reinterpret_cast<State*>(take(batch * sizeof(State)));
  int* cand_idx = reinterpret_cast<int*>(take(bn * sizeof(int)));
  float* cand_score = reinterpret_cast<float*>(take(bn * sizeof(float)));
  int* sorted_idx = reinterpret_cast<int*>(take(bn * sizeof(int)));
  float* sorted_score = reinterpret_cast<float*>(take(bn * sizeof(float)));
  float4* sorted_box = reinterpret_cast<float4*>(take(bn * sizeof(float4)));
  u64* pre = reinterpret_cast<u64*>(
      take(static_cast<size_t>(batch) * kMaxWords * sizeof(u64)));
  u64* mask = reinterpret_cast<u64*>(take(
      static_cast<size_t>(batch) * k_max * (k_max / kWord) * sizeof(u64)));
  if (a) {
    a->cand_idx = cand_idx;
    a->cand_score = cand_score;
    a->state = state;
    a->sorted_idx = sorted_idx;
    a->sorted_score = sorted_score;
    a->sorted_box = sorted_box;
    a->pre = pre;
    a->mask = mask;
  }
  return off;
}

}  // namespace

// Bytes of workspace a call with these sizes needs (16-byte aligned).
extern "C" long long dvt_nms_workspace_bytes(int batch, int n, int k_max) {
  return static_cast<long long>(carve(nullptr, batch, n, k_max, nullptr));
}

// boxes (B, N, 4) f32, 16-byte aligned; scores (B, N) f32; out_scores (B, D)
// f32; out_idx (B, D) int32; workspace of dvt_nms_workspace_bytes bytes,
// 16-byte aligned, uninitialised. Passes of k_first sorted candidates, then
// twice as many each up to k_max (multiples of 64, k_first <= k_max <= 4096).
// Enqueues both launches on `stream` without synchronising; returns the
// first cudaError_t of a launch (0 on success).
extern "C" int dvt_nms_launch(const void* boxes, const void* scores,
                              void* out_scores, void* out_idx,
                              void* workspace, int batch, int n, int d,
                              int k_first, int k_max, float iou_thr,
                              float score_thr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || d == 0) return 0;
  if (k_first < kWord || k_first > k_max || k_max > kMaxPass ||
      k_first % kWord || k_max % kWord)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  carve(static_cast<char*>(workspace), batch, n, k_max, &a);
  a.boxes = static_cast<const float4*>(boxes);
  a.out_s = static_cast<float*>(out_scores);
  a.out_i = static_cast<int*>(out_idx);
  a.batch = batch;
  a.n = n;
  a.d = d;
  a.k_first = k_first;
  a.k_max = k_max;
  a.iou_thr = iou_thr;
  const auto s = static_cast<cudaStream_t>(stream);
  nms_compact<<<batch, kCompactThreads, 0, s>>>(
      static_cast<const float*>(scores), n, d, score_thr, a.cand_idx,
      a.cand_score, a.state, a.out_s, a.out_i);
  if ((err = cudaGetLastError()) != cudaSuccess || n == 0)
    return static_cast<int>(err);
  // the cooperative grid: every block resident at once, for grid.sync()
  static int grid[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, nms_select, kThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid[device] = sms * min(per_sm, kBlocksPerSm);
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(nms_select),
                                    dim3(grid[device]), dim3(kThreads), args,
                                    0, s);
  return static_cast<int>(err);
}
