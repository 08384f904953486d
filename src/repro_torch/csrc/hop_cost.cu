// Total hop cost H = sum_{a,b} C[a, b] * (|x_a - x_b| + |y_a - y_b|)
// (the paper's Algorithm 1 contraction; average hop = H / trace length).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hop_eval/kernel.py
// (hop_cost_pallas / _hop_kernel), which walks 256 x 256 traffic tiles on
// a serial grid into one scalar accumulator kept in VMEM.  Hopper's blocks
// run in parallel and in no order, so the sum becomes a two-stage
// reduction in a fixed order, with no float atomics, so that repeated
// calls are bitwise equal:
//   stage 1: block b owns traffic rows [b * rows_per_block, ...); each
//            thread keeps a strided partial over the row tiles (coalesced
//            row reads, the distance rebuilt from the coordinates and
//            never stored), and a shared-memory tree reduction writes
//            partials[b];
//   stage 2: one block sums the partials, strided then as a tree.
// Each product is rounded to float32 as the plain version's is; the sums
// run in float64, so the result is the correctly rounded f32 of a sum
// that is itself nearly exact.
//
// Bound on an H100: memory.  The K x K f32 traffic is read once
// (K^2 * 4 bytes): ~20 us at K = 4096 (67 MB) at 3.35 TB/s.  At the slice
// run's K = 141 (80 KB) a call costs the launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ double block_sum(double v, double* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void hop_cost_partials(const float* __restrict__ traffic,
                                  const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  double* __restrict__ partials, int K,
                                  int rows_per_block) {
  __shared__ double sh[THREADS];
  const int i0 = blockIdx.x * rows_per_block;
  const int i1 = min(i0 + rows_per_block, K);
  double acc = 0.0;
  for (int i = i0; i < i1; ++i) {
    const float xi = x[i];
    const float yi = y[i];
    const float* row = traffic + static_cast<int64_t>(i) * K;
    for (int j = threadIdx.x; j < K; j += THREADS) {
      const float d = fabsf(xi - x[j]) + fabsf(yi - y[j]);
      acc += static_cast<double>(__fmul_rn(row[j], d));
    }
  }
  const double total = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void hop_cost_final(const double* __restrict__ partials,
                               int num_partials, float* __restrict__ out) {
  __shared__ double sh[THREADS];
  double acc = 0.0;
  for (int p = threadIdx.x; p < num_partials; p += THREADS) acc += partials[p];
  const double total = block_sum(acc, sh);
  if (threadIdx.x == 0) out[0] = static_cast<float>(total);
}

}  // namespace

// ``partials`` holds ceil(K / rows_per_block) doubles; ``out`` one float.
extern "C" int hop_cost_launch(const float* traffic, const float* x,
                               const float* y, double* partials, float* out,
                               int K, int rows_per_block, cudaStream_t stream) {
  if (K > 0 && rows_per_block > 0) {
    const int blocks = (K + rows_per_block - 1) / rows_per_block;
    hop_cost_partials<<<blocks, THREADS, 0, stream>>>(traffic, x, y, partials,
                                                      K, rows_per_block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hop_cost_final<<<1, THREADS, 0, stream>>>(partials, blocks, out);
  }
  return static_cast<int>(cudaGetLastError());
}
