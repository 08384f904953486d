// Total hop cost H = sum_{a,b} C[a, b] * (|x_a - x_b| + |y_a - y_b|)
// (the paper's Algorithm 1 contraction; average hop = H / trace length).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hop_eval/kernel.py:43
// (hop_cost_pallas / _hop_kernel), which walks 256 x 256 traffic tiles on
// a serial grid into one scalar accumulator kept in VMEM.  Hopper's blocks
// run in parallel and in no order, so nothing carries over between them.
//
// Design: one launch.
//   * The grid fills the card (a few blocks an SM, fewer where the work is
//     small) and grid-strides over the K x K traffic as one flat buffer of
//     16-byte float4 vectors, UNROLL of them loaded before any is used (a
//     ragged last round too): at 4 blocks an SM, 32 KB in flight an SM.
//     The traffic is read once and streamed past the caches (__ldcs).  Element e is at row e / K,
//     column e % K; a vector may cross a row end when K % 4 != 0, so the
//     general path walks its four elements with a row wrap.  The up to
//     three leading elements before the first 16-byte boundary and the up
//     to three trailing ones are summed by block 0.
//   * Where K % 4 == 0 and the buffers are 16-byte aligned, every vector
//     lies in one row at a column that is a multiple of 4: its four column
//     coordinates come in as one float4 of x and one of y (read-only cache;
//     at K = 4096 both arrays are 32 KB) and stay in registers, and the row
//     coordinate is one load a vector.
//   * Each product is rounded to float32 (__fmul_rn) as the plain version's
//     is; the sums run in float64, so the result is the correctly rounded
//     f32 of a sum that is itself nearly exact.
//   * The last block to finish sums the per-block partials: each block
//     writes its partial, fences, and takes a ticket (atomicAdd); the block
//     that draws the last ticket adds the partials in block order and
//     resets the ticket to 0 for the next call.  No float atomics, and the
//     order of every sum is fixed by K and the grid, so repeated calls are
//     bitwise equal.
//
// Bound on an H100: memory.  The K x K f32 traffic is read once
// (K^2 * 4 bytes): ~20 us at K = 4096 (67 MB) at 3.35 TB/s.  At the slice
// run's K = 141 (80 KB) a call costs latencies: the launch (~0.8 us), one
// round of loads, and ~1 us for the ticket and the last block's sum
// (tools/probe_hop_cost.py times the phases).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // 2 measured best of 2, 4, 8 at K = 4096

__device__ __forceinline__ double term(float c, float xi, float yi, float xj,
                                       float yj) {
  return static_cast<double>(__fmul_rn(c, fabsf(xi - xj) + fabsf(yi - yj)));
}

// The four elements of vector c starting at flat element e0.
template <bool kRowVectors>
__device__ __forceinline__ double vector_sum(float4 c, unsigned e0, unsigned K,
                                             const float* __restrict__ x,
                                             const float* __restrict__ y) {
  unsigned i = e0 / K;
  unsigned j = e0 - i * K;
  float xi = __ldg(x + i);
  float yi = __ldg(y + i);
  if (kRowVectors) {
    const float4 xj = __ldg(reinterpret_cast<const float4*>(x + j));
    const float4 yj = __ldg(reinterpret_cast<const float4*>(y + j));
    double s = term(c.x, xi, yi, xj.x, yj.x);
    s += term(c.y, xi, yi, xj.y, yj.y);
    s += term(c.z, xi, yi, xj.z, yj.z);
    s += term(c.w, xi, yi, xj.w, yj.w);
    return s;
  }
  const float cv[4] = {c.x, c.y, c.z, c.w};
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (j == K) {  // the vector crosses into the next row
      j = 0;
      ++i;
      xi = __ldg(x + i);
      yi = __ldg(y + i);
    }
    s += term(cv[t], xi, yi, __ldg(x + j), __ldg(y + j));
    ++j;
  }
  return s;
}

// Sum of v over the block, valid in thread 0; sh holds THREADS / 32.
__device__ double block_sum(double v, double* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // sh may still be read by the previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (warp == 0) {
    t = lane < THREADS / 32 ? sh[lane] : 0.0;
#pragma unroll
    for (int off = THREADS / 64; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
  }
  return t;
}

template <bool kRowVectors>
__global__ void __launch_bounds__(THREADS)
    hop_cost_kernel(const float* __restrict__ traffic,
                    const float* __restrict__ x, const float* __restrict__ y,
                    double* __restrict__ partials, unsigned* __restrict__ ticket,
                    float* __restrict__ out, unsigned K, unsigned n,
                    unsigned head) {
  __shared__ double sh[THREADS / 32];
  __shared__ bool last;
  const unsigned nv = (n - head) / 4;
  const float4* vec = reinterpret_cast<const float4*>(traffic + head);
  const unsigned stride = gridDim.x * THREADS;
  double acc = 0.0;
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nv;
       v += UNROLL * stride) {
    // Every load of the round is issued before the first one is used,
    // the ragged last round included.
    float4 c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * stride < nv) c[u] = __ldcs(vec + v + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * stride < nv)
        acc += vector_sum<kRowVectors>(c[u], head + 4 * (v + u * stride), K, x, y);
  }
  if (blockIdx.x == 0) {  // the scalar head and tail, at most 3 + 3
    const unsigned tail0 = head + 4 * nv;
    const unsigned t = threadIdx.x;
    if (t < head + (n - tail0)) {
      const unsigned e = t < head ? t : tail0 + (t - head);
      const unsigned i = e / K;
      const unsigned j = e - i * K;
      acc += term(traffic[e], x[i], y[i], x[j], y[j]);
    }
  }
  const double total = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (unsigned p = threadIdx.x; p < gridDim.x; p += THREADS)
    s += __ldcg(partials + p);  // from L2: other blocks wrote them
  const double sum = block_sum(s, sh);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(sum);
    *ticket = 0u;
  }
}

}  // namespace

// ``partials`` holds ``blocks`` doubles, ``ticket`` one unsigned that is 0
// before the call (and is 0 again after it), ``out`` one float.  ``head``
// is the number of leading elements before traffic's first 16-byte
// boundary; ``row_vectors`` (K % 4 == 0, head == 0, x and y 16-byte
// aligned) selects the float4 column path.  K * K must fit in 32 bits.
extern "C" int hop_cost_launch(const float* traffic, const float* x,
                               const float* y, double* partials,
                               unsigned* ticket, float* out, int K, int head,
                               int row_vectors, int blocks,
                               cudaStream_t stream) {
  if (K > 0 && blocks > 0) {
    const unsigned k = static_cast<unsigned>(K);
    const unsigned n = k * k;
    const unsigned h = static_cast<unsigned>(head) < n ? head : n;
    if (row_vectors)
      hop_cost_kernel<true><<<blocks, THREADS, 0, stream>>>(
          traffic, x, y, partials, ticket, out, k, n, h);
    else
      hop_cost_kernel<false><<<blocks, THREADS, 0, stream>>>(
          traffic, x, y, partials, ticket, out, k, n, h);
  }
  return static_cast<int>(cudaGetLastError());
}
