// All-pairs SA swap deltas
//   out[i, j] = (S D)[i, j] + (D S)[i, j] - r[i] - r[j]
//               - (diag[i] + diag[j] - 2 S[i, j]) * D[i, j]
// with D[a, b] = |x_a - x_b| + |y_a - y_b| rebuilt from the coordinates.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swap_delta/kernel.py
// (swap_deltas_pallas / _swap_kernel).  The r / diag pre-pass stays plain
// PyTorch in the wrapper, as it was XLA outside the Pallas kernel.
//
// Design: a tiled f32 SIMT kernel on the CUDA cores (no tensor cores, so
// no TF32 rounding).  Each 16 x 16 block owns a 16 x 16 output tile and
// walks the contraction dimension in 16-wide steps: the S[i, k] and
// S[k, j] tiles and the k-tile's coordinates are staged in shared memory,
// and both distance factors D[k, j] and D[i, k] are recomputed from the
// coordinates in registers, so D never touches device memory.  Both
// products accumulate in the same loop; the epilogue is fused.
//
// Bound on an H100: operations.  Two K x K x K products are 4 K^3 flops
// (67 MFLOP at K = 256) plus the distance rebuild, ~1 us at the 67 TFLOP/s
// f32 peak; the bytes (S read once, out written once: 0.5 MB) take
// ~0.16 us.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;

__global__ void swap_deltas_kernel(const float* __restrict__ S,
                                   const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ r,
                                   const float* __restrict__ diag,
                                   float* __restrict__ out, int K) {
  __shared__ float s_ik[TILE][TILE + 1];  // S[i, k0 + kk]
  __shared__ float s_kj[TILE][TILE + 1];  // S[k0 + kk, j]
  __shared__ float xk[TILE];
  __shared__ float yk[TILE];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i = blockIdx.y * TILE + ty;
  const int j = blockIdx.x * TILE + tx;
  const float xi = i < K ? x[i] : 0.0f;
  const float yi = i < K ? y[i] : 0.0f;
  const float xj = j < K ? x[j] : 0.0f;
  const float yj = j < K ? y[j] : 0.0f;
  float sd = 0.0f;
  float ds = 0.0f;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    const int kc = k0 + tx;
    const int kr = k0 + ty;
    // Out-of-range entries load as zero traffic, which contributes nothing.
    s_ik[ty][tx] = (i < K && kc < K) ? S[static_cast<int64_t>(i) * K + kc] : 0.0f;
    s_kj[ty][tx] = (kr < K && j < K) ? S[static_cast<int64_t>(kr) * K + j] : 0.0f;
    if (ty == 0) {
      xk[tx] = kc < K ? x[kc] : 0.0f;
      yk[tx] = kc < K ? y[kc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) {
      const float d_kj = fabsf(xk[kk] - xj) + fabsf(yk[kk] - yj);
      const float d_ik = fabsf(xi - xk[kk]) + fabsf(yi - yk[kk]);
      sd += s_ik[ty][kk] * d_kj;
      ds += d_ik * s_kj[kk][tx];
    }
    __syncthreads();
  }
  if (i < K && j < K) {
    const float d_ij = fabsf(xi - xj) + fabsf(yi - yj);
    const float s_ij = S[static_cast<int64_t>(i) * K + j];
    out[static_cast<int64_t>(i) * K + j] =
        sd + ds - r[i] - r[j] - (diag[i] + diag[j] - 2.0f * s_ij) * d_ij;
  }
}

}  // namespace

extern "C" int swap_deltas_launch(const float* S, const float* x,
                                  const float* y, const float* r,
                                  const float* diag, float* out, int K,
                                  cudaStream_t stream) {
  if (K > 0) {
    const dim3 threads(TILE, TILE);
    const dim3 blocks((K + TILE - 1) / TILE, (K + TILE - 1) / TILE);
    swap_deltas_kernel<<<blocks, threads, 0, stream>>>(S, x, y, r, diag, out,
                                                       K);
  }
  return static_cast<int>(cudaGetLastError());
}
