// The fixed-order column sum of a matrix of per-block partial sums, shared
// by bn_act.cu (dscale, dbias) and norm.cu (the moments and LayerNorm's
// dscale, dbias). The order is part of the result: it is what makes these
// sums repeat bit for bit from run to run, and what the CPU models of the
// kernels (tests/test_torch_norm_plan.py) reproduce.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// a block of kColumnSumCols x kColumnSumGroups threads owns kColumnSumCols
// columns
constexpr int kColumnSumCols = 32;
constexpr int kColumnSumGroups = 8;

// Sums two columns at once, (load(j, ch).x, load(j, ch).y) over rows
// j = 0 .. rows - 1, for column ch = blockIdx.x * kColumnSumCols +
// threadIdx.x: thread (tx, ty) sums rows ty, ty + 8, ... in order, then
// thread (tx, 0) adds the 8 group sums in order. Returns true on the one
// thread that holds column ch's total (ty == 0, ch < c), with ch and the
// total in `ch` and `total`. Every thread of the block must call it.
template <typename Load>
__device__ __forceinline__ bool column_sum(int64_t rows, int c, Load load,
                                           int& ch, float2& total) {
  __shared__ float2 sums[kColumnSumGroups][kColumnSumCols];
  ch = blockIdx.x * kColumnSumCols + threadIdx.x;
  float2 s = make_float2(0.0f, 0.0f);
  if (ch < c) {
#pragma unroll 8
    for (int64_t j = threadIdx.y; j < rows; j += kColumnSumGroups) {
      const float2 v = load(j, ch);
      s.x += v.x;
      s.y += v.y;
    }
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || ch >= c) return false;
  total = sums[0][threadIdx.x];
#pragma unroll
  for (int k = 1; k < kColumnSumGroups; ++k) {
    total.x += sums[k][threadIdx.x].x;
    total.y += sums[k][threadIdx.x].y;
  }
  return true;
}
