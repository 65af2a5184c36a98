// Greedy non-maximum suppression for Hopper (sm_90a), one thread block per
// image.
//
// Replaces the TPU kernel `_nms_kernel` launched by `pallas_nms`
// (deep_vision_tpu/ops/pallas/nms.py:42, call at :113) and computes what it
// computes, bit for bit: scores below `score_thr` become -1; each of the D
// rounds takes the largest live score (the lowest index on ties), keeps it
// only if it is > 0, writes it to the output slot, and suppresses every live
// candidate whose IoU with it is >= `iou_thr`, and the pick itself. IoU clips
// sides at 0 and floors the union at 1e-9, and is evaluated in the same
// order as the reference: inter = iw * ih; union = (area + barea) - inter.
// The build uses --fmad=false and no fast math: a contracted multiply-add or
// an approximate division would round differently and flip `iou >= thr`
// against the plain version.
//
// Design. The live scores stay in shared memory (10,647 x 4 B = 42.6 KB at
// YOLO-416); where N does not fit in what a block may use, they live in a
// global scratch row the wrapper allocates, through the same code. Boxes are
// read from global memory as one float4 per candidate and stay in L2 across
// rounds. Each round is one fused block reduction of (score, index) pairs --
// larger score wins, equal scores go to the lower index, which equals a
// block max followed by a min-index over the candidates attaining it --
// through warp shuffles and one shared-memory pass, then one thread writes
// the slot, then every thread suppresses its strided share. Each thread
// only ever reads back live scores it wrote itself, so two barriers per
// round suffice. Once a round keeps nothing, no later round can, so the
// loop ends and the remaining slots are filled with (0, -1).
//
// What bounds it. B <= 8 blocks at serving time leave 124+ of the 132 SMs
// idle, and the D rounds are serial, each with two block-wide barriers and
// a dependent global load of the picked box: the kernel is bound by latency,
// not by the ~0.4 MB it reads per image nor by its arithmetic. A later
// version could compute a bitmask IoU matrix over the candidates above
// threshold with all SMs (one tile of rows per block), then run the serial
// scan over 64-bit masks in one warp, keeping the same first-index order.
#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(0xffffffffu, x.v, off);
    o.i = __shfl_down_sync(0xffffffffu, x.i, off);
    x = better(x, o);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           float* __restrict__ out_scores, int* __restrict__ out_idx,
           float* __restrict__ scratch, int n, int d, float iou_thr,
           float score_thr) {
  extern __shared__ float smem_live[];
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_i[kWarps];
  __shared__ float4 s_box;
  __shared__ float s_best;
  __shared__ int s_bi;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* bx = boxes + static_cast<size_t>(b) * n;
  const float* sc = scores + static_cast<size_t>(b) * n;
  float* live = scratch ? scratch + static_cast<size_t>(b) * n : smem_live;
  float* os = out_scores + static_cast<size_t>(b) * d;
  int* oi = out_idx + static_cast<size_t>(b) * d;

  for (int j = tid; j < n; j += kThreads) {
    const float s = sc[j];
    live[j] = s >= score_thr ? s : -1.0f;
  }

  int round = 0;
  for (; round < d; ++round) {
    Best mine = {-FLT_MAX, INT_MAX};
    for (int j = tid; j < n; j += kThreads) mine = better(mine, Best{live[j], j});
    mine = warp_best(mine);
    if (lane == 0) {
      s_warp_v[warp] = mine.v;
      s_warp_i[warp] = mine.i;
    }
    __syncthreads();
    if (warp == 0) {
      Best w = {s_warp_v[lane], s_warp_i[lane]};
      w = warp_best(w);
      if (lane == 0) {
        s_best = w.v;
        s_bi = w.i;
        if (w.v > 0.0f) {
          os[round] = w.v;
          oi[round] = w.i;
          s_box = bx[w.i];
        }
      }
    }
    __syncthreads();
    if (!(s_best > 0.0f)) break;  // uniform: every thread reads the same value
    const int bi = s_bi;
    const float4 sb = s_box;
    const float barea = fmaxf(sb.z - sb.x, 0.0f) * fmaxf(sb.w - sb.y, 0.0f);
    for (int j = tid; j < n; j += kThreads) {
      if (j == bi) {
        live[j] = -1.0f;
        continue;
      }
      const float4 c = bx[j];
      const float iw = fmaxf(fminf(c.z, sb.z) - fmaxf(c.x, sb.x), 0.0f);
      const float ih = fmaxf(fminf(c.w, sb.w) - fmaxf(c.y, sb.y), 0.0f);
      const float inter = iw * ih;
      const float area = fmaxf(c.z - c.x, 0.0f) * fmaxf(c.w - c.y, 0.0f);
      const float iou = inter / fmaxf(area + barea - inter, 1e-9f);
      if (iou >= iou_thr) live[j] = -1.0f;
    }
  }
  for (int k = round + tid; k < d; k += kThreads) {
    os[k] = 0.0f;
    oi[k] = -1;
  }
}

}  // namespace

// Candidates whose live scores fit in one block's shared memory on `device`
// beside the kernel's static shared memory; -1 on a CUDA error.
extern "C" int dvt_nms_max_smem_candidates(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, nms_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>((optin - static_cast<int>(attr.sharedSizeBytes)) /
                          static_cast<int>(sizeof(float)));
}

// boxes (B, N, 4) f32, 16-byte aligned; scores (B, N) f32; out_scores (B, D)
// f32; out_idx (B, D) int32; scratch (B, N) f32 or null (null: live scores
// in shared memory, N <= dvt_nms_max_smem_candidates). Launches on `stream`
// without synchronising; returns the cudaError_t of the launch.
extern "C" int dvt_nms_launch(const void* boxes, const void* scores,
                              void* out_scores, void* out_idx, void* scratch,
                              int batch, int n, int d, float iou_thr,
                              float score_thr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || d == 0) return 0;
  const size_t smem = scratch ? 0 : static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<float*>(out_scores), static_cast<int*>(out_idx),
      static_cast<float*>(scratch), n, d, iou_thr, score_thr);
  return static_cast<int>(cudaGetLastError());
}
