// Volume-mode degree rows from the sparse incidence and the live Φ table
//   D*[r, c] = sum over the hyperedges e of vertex rows[r] of
//              w[e] * [phi(e, c) > (c == own[r])]
// where w = hfire, phi (E, k) is the member-count table Φ and own[r] the
// row vertex's partition: a column counts a hyperedge with a member
// there, and the own column one with a second member (the row vertex
// always sits there itself).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gain_eval/kernel.py
// (connectivity_matmul_pallas / _matmul_kernel), a dense 128-tiled MXU
// matmul of the (n, E) hfire-weighted incidence with the (E, 2k) presence
// [phi > 0 | phi > 1], together with the own-column overwrite the
// reference's wrapper applies after it (src/repro/core/refine_vec.py,
// _volume_degrees_via_kernel).  The incidence is > 99% zeros on the
// refiner's levels, so on Hopper it stays sparse: the vertex -> hyperedge
// CSR (vxadj, vedges) with the weights w = hfire[vedges] beside it, put on
// the card once per level; Φ lives on the card as int32 and the refiner
// applies its ±count updates there.
//
// Design: one 256-thread block per requested row.  The block copies the
// row's list of (e, w) entries into shared memory with cp.async, SEG
// entries at a time in ascending list order; its 8 warps split the list,
// each taking NB consecutive entries per step, so 32 Φ rows of one row's
// list are in flight at once.  Each lane owns columns c = lane + 32 j and
// sums w * [phi(e, c) > (c == own)] over its warp's entries: one
// coalesced 4-byte read of each Φ row across the lanes decides both
// presence halves and the own-column rule.  The warps' partial sums are
// added in a fixed order through shared memory.  Why not a warp per row
// (or 2-4 rows a block): measured on the H100, a warp walking its list
// alone is bound by one L2 round trip per entry (15.8 us for 64 rows of 32
// entries, 35 us a launch on the volume run, whose calls are small row
// subsets of coarse levels with long lists); the time of a call is its
// longest list's walk, so the parallelism goes into each row.  At k = 141
// CPL = 5 columns a lane cover the row in one pass with 88% of the lanes
// busy; larger k runs further passes over the list.  No atomics, no scan
// over zeros.
//
// Bound on an H100: memory.  The requested rows' lists (8 bytes an entry),
// Φ once (4 E k bytes; L2-resident across blocks), the row and own ids
// (16 bytes a row) and the (R, k) f32 output; at R = 3072, E = 4096,
// k = 141 and 32 entries a row that is ~4.8 MB, ~1.4 us at 3.35 TB/s.
//
// Exactness: the refiner takes this path only while 2 * sum(hfire) is
// below 2**24 (refine_vec's gate), so every partial sum is an integer that
// float32 holds exactly; the result equals the plain version bit for bit
// whatever the summation order (which here is fixed: each warp's entries
// in ascending list order, then the warps in order).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps sharing one row's list
constexpr int THREADS = 32 * WARPS;
constexpr int SEG = 1024;  // list entries staged at a time
constexpr int CPL = 5;     // columns per lane per pass: 160 >= k = 141
constexpr int NB = 4;      // list entries a warp reads per step

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(THREADS)
volume_degree_rows_kernel(const int* __restrict__ vxadj,
                          const int* __restrict__ vedges,
                          const float* __restrict__ w,
                          const int* __restrict__ phi,
                          const int64_t* __restrict__ rows,
                          const int64_t* __restrict__ own,
                          float* __restrict__ out, int k) {
  __shared__ int s_e[SEG];
  __shared__ float s_w[SEG];
  __shared__ float s_part[WARPS][32 * CPL];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t v = rows[blockIdx.x];
  const int o = static_cast<int>(own[blockIdx.x]);
  const int beg = vxadj[v];
  const int end = vxadj[v + 1];
  float* orow = out + static_cast<int64_t>(blockIdx.x) * k;

  for (int c0 = 0; c0 < k; c0 += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
    for (int s0 = beg; s0 < end; s0 += SEG) {
      const int n = min(SEG, end - s0);
      __syncthreads();  // every warp is done with the previous segment
      for (int i = tid; i < n; i += THREADS) {
        cp_async4(&s_e[i], vedges + s0 + i);
        cp_async4(&s_w[i], w + s0 + i);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // the segment is visible to every warp
      for (int i0 = warp * NB; i0 < n; i0 += WARPS * NB) {
        // Issue all NB x CPL loads before any use.
        int val[NB][CPL];
        float wb[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const bool ok = i0 + b < n;
          const int* prow = phi + static_cast<int64_t>(ok ? s_e[i0 + b] : 0) * k;
          wb[b] = ok ? s_w[i0 + b] : 0.0f;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            val[b][j] = ok && c < k ? __ldg(prow + c) : 0;
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            acc[j] += val[b][j] > (c == o) ? wb[b] : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) s_part[warp][lane + 32 * j] = acc[j];
    __syncthreads();
    for (int c = tid; c < 32 * CPL && c0 + c < k; c += THREADS) {
      float sum = s_part[0][c];
#pragma unroll
      for (int q = 1; q < WARPS; ++q) sum += s_part[q][c];
      orow[c0 + c] = sum;
    }
    __syncthreads();  // s_part is rewritten by the next column pass
  }
}

}  // namespace

extern "C" int connectivity_degrees_launch(const int* vxadj, const int* vedges,
                                           const float* w, const int* phi,
                                           const int64_t* rows,
                                           const int64_t* own, float* out,
                                           int k, int num_rows,
                                           cudaStream_t stream) {
  if (num_rows > 0 && k > 0) {
    volume_degree_rows_kernel<<<num_rows, THREADS, 0, stream>>>(
        vxadj, vedges, w, phi, rows, own, out, k);
  }
  return static_cast<int>(cudaGetLastError());
}
