// Per-window XY link loads of a batch of (K, K) core-to-core count matrices.
//
//   loads[b, link] = sum of counts[b, s, d] over the (s, d) whose XY route
//                    crosses the directed link
//
// in the flat directed-link id layout of nocsim/xy.py (east, west, south,
// north blocks).  Core s sits at (x[s], y[s]) on a W x H mesh.
//
// Replaces the Pallas TPU kernel src/repro/kernels/link_load/kernel.py
// (link_loads_pallas / _kernel), whose indicator-matrix matmuls served
// the TPU's matrix unit.  On Hopper the route histogram is computed
// directly: one thread per (window, src, dst) entry with a non-zero count
// walks its XY route (the X leg along the source row, then the Y leg
// along the destination column) and adds the count to every link it
// crosses with an int32 atomicAdd.  Integer atomics make the result exact
// and independent of the order the threads run in.
//
// The adds go to a per-block histogram of the window's links in shared
// memory (a 16x16 mesh has 960 links: 3.8 KB), not to device memory: a
// hot link collects thousands of adds per window, and shared-memory
// atomics absorb that contention.  Each block covers one slice of one
// window's K*K entries (enough slices to put ~2 blocks on every SM) and
// flushes its non-zero bins with one global atomicAdd each.
//
// Bound on an H100: memory.  The counts are read once (4 B * B * K^2:
// 67 MB at B = 256 windows, K = 256 cores), coalesced, and the (B, links)
// loads are written once; the atomics touch only non-zero entries, which
// in a spike trace are a small fraction of the matrix.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void link_loads_kernel(const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ x,
                                  const int32_t* __restrict__ y,
                                  int32_t* __restrict__ loads, int K, int W,
                                  int H, int slices) {
  extern __shared__ int32_t hist[];
  const int nl = 2 * (W - 1) * H + 2 * W * (H - 1);
  const int w_base = (W - 1) * H;
  const int s_base = 2 * (W - 1) * H;
  const int n_base = s_base + W * (H - 1);
  for (int i = threadIdx.x; i < nl; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t b = blockIdx.x / slices;
  const int64_t slice = blockIdx.x % slices;
  const int64_t kk = static_cast<int64_t>(K) * K;
  const int64_t per = (kk + slices - 1) / slices;
  const int64_t lo = slice * per;
  const int64_t hi = lo + per < kk ? lo + per : kk;
  const int32_t* c_win = counts + b * kk;
  for (int64_t e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    const int32_t c = c_win[e];
    if (c == 0) continue;
    const int s = static_cast<int>(e / K);
    const int d = static_cast<int>(e - static_cast<int64_t>(s) * K);
    const int sx = x[s], sy = y[s], dx = x[d], dy = y[d];
    // X leg along row sy: east over links sx..dx-1, west over dx..sx-1.
    for (int w = sx; w < dx; ++w) atomicAdd(&hist[sy * (W - 1) + w], c);
    for (int w = dx; w < sx; ++w) atomicAdd(&hist[w_base + sy * (W - 1) + w], c);
    // Y leg along column dx: south over sy..dy-1, north over dy..sy-1.
    for (int q = sy; q < dy; ++q) atomicAdd(&hist[s_base + dx * (H - 1) + q], c);
    for (int q = dy; q < sy; ++q) atomicAdd(&hist[n_base + dx * (H - 1) + q], c);
  }
  __syncthreads();
  int32_t* out = loads + b * nl;
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

}  // namespace

extern "C" int link_loads_launch(const int32_t* counts, const int32_t* x,
                                 const int32_t* y, int32_t* loads, int B,
                                 int K, int W, int H, cudaStream_t stream) {
  const int nl = 2 * (W - 1) * H + 2 * W * (H - 1);
  cudaError_t err = cudaMemsetAsync(
      loads, 0, static_cast<size_t>(B) * nl * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && K > 0) {
    const int threads = 256;
    // Slices per window: ~2 blocks per SM in all, at least 1024 entries each.
    const int64_t kk = static_cast<int64_t>(K) * K;
    int64_t slices = (2 * 132 + B - 1) / B;
    const int64_t max_slices = (kk + 1023) / 1024;
    if (slices > max_slices) slices = max_slices;
    if (slices < 1) slices = 1;
    const size_t smem = static_cast<size_t>(nl) * sizeof(int32_t);
    link_loads_kernel<<<static_cast<int>(B * slices), threads, smem, stream>>>(
        counts, x, y, loads, K, W, H, static_cast<int>(slices));
  }
  return static_cast<int>(cudaGetLastError());
}
