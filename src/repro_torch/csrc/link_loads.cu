// Per-window XY link loads of window-sorted packet records.
//
//   loads[w, link] = sum of count[r] over the records r of window w whose
//                    XY route (src[r] -> dst[r]) crosses the directed link
//
// in the flat directed-link id layout of nocsim/xy.py (east, west, south,
// north blocks).  Core c sits at (x[c], y[c]) on a W x H mesh.  Records
// are one int32 each, (src << 16) | dst, sorted by window; window w owns
// records woff[w] .. woff[w+1]-1.  count is null (every record is one
// packet) or one int32 a record.
//
// Replaces the Pallas TPU kernel src/repro/kernels/link_load/kernel.py:99
// (link_loads_pallas / _kernel), whose indicator-matrix matmuls over dense
// (K, K) count matrices served the TPU's matrix unit.  On Hopper the route
// histogram is computed from the records the replay already holds: no
// dense (B, K, K) matrix is built or read.
//
// Design.  Blocks take chunks of 4,096 records (grid-stride); a chunk is
// cut at window boundaries (binary search in woff) into segments of one
// window each.  A segment of at least 256 records is histogrammed in
// shared memory (one int32 bin a link: 960 bins, 3.8 KB on a 16 x 16
// mesh) and its non-zero bins are flushed with one global atomicAdd each;
// a shorter segment adds straight to the output.  Within a warp, records
// with equal routes — consecutive packets of one firing sent to one core —
// are merged with __match_any_sync: the group's leader walks the route
// once and adds the group's total (popc, or the sum of its counts).
// Integer atomics keep the result exact and independent of the order in
// which blocks and warps run.
//
// Bound on an H100: memory.  The records are read once (4 B each, plus
// the counts when given, and woff), and the (windows, links) int32 loads
// are written once: ~20 MB on the cut slice run's 4,578,533 packets in
// 418 windows, ~6 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;
constexpr int kSharedMin = 256;  // shortest segment worth a shared histogram

struct Mesh {
  const int32_t* x;
  const int32_t* y;
  int W, H, w_base, s_base, n_base;
};

// Add c to every link of the XY route s -> d in bins (shared or global).
__device__ __forceinline__ void add_route(int32_t* bins, const Mesh& m, int s,
                                          int d, int32_t c) {
  const int sx = m.x[s], sy = m.y[s], dx = m.x[d], dy = m.y[d];
  // X leg along row sy: east over links sx..dx-1, west over dx..sx-1.
  for (int w = sx; w < dx; ++w) atomicAdd(&bins[sy * (m.W - 1) + w], c);
  for (int w = dx; w < sx; ++w)
    atomicAdd(&bins[m.w_base + sy * (m.W - 1) + w], c);
  // Y leg along column dx: south over sy..dy-1, north over dy..sy-1.
  for (int q = sy; q < dy; ++q)
    atomicAdd(&bins[m.s_base + dx * (m.H - 1) + q], c);
  for (int q = dy; q < sy; ++q)
    atomicAdd(&bins[m.n_base + dx * (m.H - 1) + q], c);
}

// Every thread of the block walks records lo..hi-1 of one window, a warp
// 32 consecutive records at a time, and adds their routes to bins.
__device__ void add_segment(int32_t* bins, const Mesh& m,
                            const int32_t* __restrict__ rec,
                            const int32_t* __restrict__ count, int64_t lo,
                            int64_t hi, int32_t* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t base = lo + 32 * warp; base < hi; base += kThreads) {
    const int64_t r = base + lane;
    const bool valid = r < hi;
    const int32_t key = valid ? rec[r] : -1;
    const int32_t c = valid ? (count != nullptr ? count[r] : 1) : 0;
    const unsigned group = __match_any_sync(0xffffffffu, key);
    int32_t total = __popc(group);
    if (count != nullptr) {
      scratch[warp * 32 + lane] = c;
      __syncwarp();
      total = 0;
      for (unsigned g = group; g; g &= g - 1)
        total += scratch[warp * 32 + __ffs(g) - 1];
      __syncwarp();
    }
    if (valid && lane == __ffs(group) - 1 && total != 0)
      add_route(bins, m, key >> 16, key & 0xffff, total);
  }
}

__global__ void link_loads_kernel(const int32_t* __restrict__ rec,
                                  const int32_t* __restrict__ count,
                                  const int32_t* __restrict__ woff,
                                  int n_win, int64_t n, Mesh m, int nl,
                                  int32_t* __restrict__ loads) {
  extern __shared__ int32_t hist[];  // nl bins
  __shared__ int32_t scratch[kThreads];
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  for (int64_t chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    int64_t lo = chunk * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    // The window holding record lo: the last w with woff[w] <= lo.
    int a = 0, b = n_win;  // woff[a] <= lo < woff[b]
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (woff[mid] <= lo) a = mid; else b = mid;
    }
    for (int w = a; lo < hi; ++w) {
      const int64_t end = woff[w + 1] < hi ? woff[w + 1] : hi;
      if (end <= lo) continue;  // an empty window
      int32_t* out = loads + static_cast<int64_t>(w) * nl;
      if (end - lo < kSharedMin) {
        add_segment(out, m, rec, count, lo, end, scratch);
      } else {
        for (int i = threadIdx.x; i < nl; i += kThreads) hist[i] = 0;
        __syncthreads();
        add_segment(hist, m, rec, count, lo, end, scratch);
        __syncthreads();
        for (int i = threadIdx.x; i < nl; i += kThreads) {
          const int32_t v = hist[i];
          if (v != 0) atomicAdd(&out[i], v);
        }
        __syncthreads();  // hist is zeroed again for the next segment
      }
      lo = end;
    }
  }
}

}  // namespace

extern "C" int link_loads_launch(const int32_t* rec, const int32_t* count,
                                 const int32_t* woff, const int32_t* x,
                                 const int32_t* y, int32_t* loads, int n_win,
                                 int n, int W, int H, cudaStream_t stream) {
  const int nl = 2 * (W - 1) * H + 2 * W * (H - 1);
  cudaError_t err = cudaMemsetAsync(
      loads, 0, static_cast<size_t>(n_win) * nl * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && n_win > 0) {
    const int64_t chunks = (static_cast<int64_t>(n) + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>(chunks < 132 * 16 ? chunks : 132 * 16);
    Mesh m{x, y, W, H, (W - 1) * H, 2 * (W - 1) * H,
           2 * (W - 1) * H + W * (H - 1)};
    const size_t smem = static_cast<size_t>(nl) * sizeof(int32_t);
    link_loads_kernel<<<blocks, kThreads, smem, stream>>>(
        rec, count, woff, n_win, n, m, nl, loads);
  }
  return static_cast<int>(cudaGetLastError());
}
