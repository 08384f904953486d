// Connectivity-mode degree rows D*[r, c] = sum_e inc[rows[r], e] * pres[e, c].
//
// Replaces the Pallas TPU kernel src/repro/kernels/gain_eval/kernel.py
// (connectivity_matmul_pallas / _matmul_kernel), a dense 128-tiled MXU
// matmul of the (n, E) hfire-weighted incidence with the (E, 2k) presence
// [phi > 0 | phi > 1].  The incidence is sparse but stored dense (a coarse
// level of edge_5120 has ~30-110 non-zeros in a row of E = 4096), so on
// Hopper the product is rethought as a gather: one block per requested
// row scans the row's E entries with coalesced loads, compacts its
// non-zeros (e, w) into shared memory in ascending e (warp ballots and a
// block prefix over the warps, no atomics), and then each thread owns
// output columns and sums w * pres[e, c] over the list; the reads of a
// presence row are coalesced across the threads.  Rows longer than SEG
// entries are scanned in SEG-wide segments, the column sums carried in
// shared memory between them.
//
// Bound on an H100: memory.  Each requested incidence row is read once
// (4E bytes), the presence once (8Ek bytes, L2-resident across blocks)
// and 8k bytes written per row; at R = n = 3072, E = 4096, k = 141 that
// is ~58 MB, ~17 us at 3.35 TB/s.  The multiply-adds, 2 * nnz * 2k, are
// a few MFLOP.
//
// Exactness: the refiner takes this path only while 2 * sum(hfire) is
// below 2**24 (refine_vec's gate), so every partial sum is an integer
// that float32 holds exactly; the result equals the plain version bit for
// bit whatever the summation order (which here is fixed: ascending e).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 2048;  // incidence entries compacted per pass

__global__ void connectivity_degrees_kernel(const float* __restrict__ inc,
                                            const float* __restrict__ pres,
                                            const int64_t* __restrict__ rows,
                                            float* __restrict__ out, int E,
                                            int C) {
  // Dynamic shared memory: acc[C] | w[SEG] | e[SEG].
  extern __shared__ float smem[];
  float* acc = smem;
  float* lw = acc + C;
  int* le = reinterpret_cast<int*>(lw + SEG);
  __shared__ int warp_nnz[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  // Each thread owns columns tid, tid + THREADS, ...: no sharing of acc.
  for (int c = tid; c < C; c += THREADS) acc[c] = 0.0f;
  const float* a = inc + rows[blockIdx.x] * static_cast<int64_t>(E);
  for (int s0 = 0; s0 < E; s0 += SEG) {
    const int s1 = min(s0 + SEG, E);
    int count = 0;  // list length so far, the same in every thread
    for (int base = s0; base < s1; base += THREADS) {
      const int e = base + tid;
      const float w = e < s1 ? a[e] : 0.0f;
      const bool nz = w != 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, nz);
      if (lane == 0) warp_nnz[warp] = __popc(ballot);
      __syncthreads();
      int off = count;
      int total = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) {
        const int cnt = warp_nnz[q];
        off += q < warp ? cnt : 0;
        total += cnt;
      }
      if (nz) {
        const int pos = off + __popc(ballot & below);
        le[pos] = e;
        lw[pos] = w;
      }
      count += total;
      __syncthreads();  // list entries visible; warp_nnz free for reuse
    }
    for (int c = tid; c < C; c += THREADS) {
      float s = acc[c];
      for (int i = 0; i < count; ++i) {
        s += lw[i] * pres[static_cast<int64_t>(le[i]) * C + c];
      }
      acc[c] = s;
    }
    __syncthreads();  // every thread is done with the list before refill
  }
  float* o = out + static_cast<int64_t>(blockIdx.x) * C;
  for (int c = tid; c < C; c += THREADS) o[c] = acc[c];
}

}  // namespace

// The wrapper keeps C * 4 + SEG * 8 within the 48 KB a block gets without
// opting in (C <= 8192, k <= 4096).
extern "C" int connectivity_degrees_launch(const float* inc, const float* pres,
                                           const int64_t* rows, float* out,
                                           int E, int C, int num_rows,
                                           cudaStream_t stream) {
  if (num_rows > 0 && C > 0) {
    const size_t smem = static_cast<size_t>(C) * sizeof(float) +
                        static_cast<size_t>(SEG) * (sizeof(float) + sizeof(int));
    connectivity_degrees_kernel<<<num_rows, THREADS, smem, stream>>>(
        inc, pres, rows, out, E, C);
  }
  return static_cast<int>(cudaGetLastError());
}
