// All-pairs SA swap deltas on the tensor cores, one launch per call
//   out[i, j] = (S D)[i, j] + (D S)[i, j] - r[i] - r[j]
//               - (S[i, i] + S[j, j] - 2 S[i, j]) * D[i, j]
//   r[i]      = sum_k S[i, k] D[i, k]
// with D[a, b] = |x_a - x_b| + |y_a - y_b| rebuilt from the coordinates
// and never stored.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swap_delta/kernel.py
// (swap_deltas_pallas / _swap_kernel) and the r / diag pre-pass the
// reference ran beside it: r is summed from the S row tiles the block
// stages anyway, the diagonal is read from S, so a call is one launch.
//
// Symmetry.  The caller's contract is that S is symmetric (C + C^T); D is
// symmetric by construction.  Then D S = (S D)^T and out is symmetric, so
// only tile pairs bi <= bj get a block: it stages the S row tiles of bi
// and of bj over the contraction, accumulates its tile of S D (A = S rows
// of bi, B = D built from coordinates) and of D S (A = D, B = S[k, bj] =
// S rows of bj), and writes the tile and its mirror.  On a diagonal tile
// the upper triangle is written to both halves, so out is exactly
// symmetric, and the diagonal is written as exactly 0 (swapping a
// partition with itself changes nothing; the plain version's diagonal is
// 0 up to f32 rounding).  This halves the work of the two K^3 products.
//
// Exact products on TF32 tensor cores (mma.sync m16n8k8 .tf32).  TF32
// operands keep 11 significant bits.  D holds integers <= 2 (mesh side - 1)
// (<= 62 on a 32 x 32 mesh), exact in TF32, and its fragments are built in
// registers straight from the coordinates.  S is split by mantissa masking
// into S = S_hi + S_mid + S_lo: hi keeps the top 11 of f32's 24 significant
// bits, mid the next 11 of the (exact) remainder, lo the last <= 2 bits, so
// each part is exact in TF32 and the split itself is exact.  Every product
// the tensor cores form is then exact; only the f32 accumulation rounds,
// as in a plain f32 product.  A warp skips the MMAs of a split whose
// fragments are all zero in its k8 step (a vote), so traffic that fits in
// 11 significant bits (integers below 2048, as on the slice runs) costs
// one split, not three.  The tensor cores' own adds may truncate, so
// each k8 step's MMAs (two to six) sum into a fresh accumulator added to
// the running f32 sum with an ordinary (round-to-nearest) add.  For
// integer traffic whose partial sums stay below 2^24 (the slice runs)
// every value is an exact integer and the result equals the plain version
// bit for bit.  There is no TF32 rounding anywhere: ROADMAP's "no TF32"
// rule is about rounded operands, and none are rounded here.
//
// Pipeline.  A block of 4 warps owns a TILE x TILE output tile: TILE = 16
// for K <= 512, so that K = 256 still spreads over 136 blocks (32-wide
// tiles would give 36 for the 132 SMs), and TILE = 32 above, where the
// wider tile halves the fragment-building work per MMA.
// The contraction walks 32-wide k-tiles; the S row tiles and the k-tile's
// coordinates are staged with cp.async into a ring of shared-memory stages
// (8 for 16-wide tiles, all of K = 256 in flight at once; 4 for 32-wide),
// so later k-tiles' loads overlap the current one's MMAs.  At most 128
// registers a thread, so that four 32-wide blocks fit an SM and K = 1024's
// 528 blocks run in one wave.  Each warp takes
// one 8-wide k-slice of the k-tile for the whole output tile (split-K in
// the block); the four partial tiles are summed in a fixed order through
// shared memory before the fused epilogue.  Any K: rows and columns past
// K load as zero traffic, which contributes nothing, and are not written.
//
// Bound on an H100: operations (bytes at K = 256 with one split).  With
// the symmetry the block grid does
// 2 K^3 flops per split S needs (one for integers below 2048, at most
// three): 2-6 K^3 TF32 flops (0.03-0.1 GFLOP at K = 256, 2.1-6.4 GFLOP at
// K = 1024) over 494.7 TFLOP/s TF32 dense; the bytes (S read once, out
// written once) are below that from K ~ 128 on.  What holds it back
// (tools/probe_swap_deltas.py times variants with parts cut out): at
// K = 1024 the staging itself, since 32-wide tiles re-read 2 x 32 rows of
// S per k-tile from L2 (~138 MB in all), takes about half the time, the
// MMAs and the r sums most of the rest; at K = 256, one block an SM runs
// a short serial chain (launch, first k-tile, 8 k-steps, epilogue).
// Larger tiles on wgmma with TMA staging are the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;        // k-tile width: one 8-wide k-slice per warp
constexpr int LDS = BK + 4;   // padded row: 16-byte aligned, conflict-free fragments
constexpr uint32_t TF32_MASK = 0xffffe000u;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of BYTES (4 or 16); the bytes past
// src_bytes are zero-filled (src_bytes = 0 stores zeros).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + mid + lo exactly, each part exact in TF32 (low 13 bits zero).
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = __float_as_uint(v) & TF32_MASK;
  const float r = v - __uint_as_float(hi);
  mid = __float_as_uint(r) & TF32_MASK;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

__device__ __forceinline__ float manhattan(float xa, float ya, float xb,
                                           float yb) {
  return fabsf(xa - xb) + fabsf(ya - yb);
}

__device__ __forceinline__ uint32_t dist_u32(float xa, float ya, float xb,
                                             float yb) {
  return __float_as_uint(manhattan(xa, ya, xb, yb));
}

template <int TILE, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
swap_deltas_kernel(const float* __restrict__ S, const float* __restrict__ x,
                   const float* __restrict__ y, float* __restrict__ out,
                   int K) {
  constexpr int STAGES = TILE == 16 ? 8 : 4;  // cp.async ring depth
  constexpr int MT = TILE / 16;        // m16 fragments per warp
  constexpr int NT = TILE / 8;         // n8 fragments per warp
  constexpr int ROWS = 2 * TILE;       // staged rows: tile bi's, then bj's
  constexpr int TPR = THREADS / ROWS;  // threads summing one row of r
  constexpr int KPT = BK / TPR;        // k-tile columns per such thread
  static_assert(THREADS % ROWS == 0 && BK % TPR == 0, "r split");
  static_assert(WARPS * 8 == BK, "one k8 slice per warp");
  static_assert(WARPS * TILE * (TILE + 1) <= STAGES * ROWS * LDS,
                "the split-K reduction reuses the staging buffers");

  __shared__ __align__(16) float s_rows[STAGES][ROWS][LDS];
  __shared__ __align__(16) float s_xk[STAGES][BK];
  __shared__ __align__(16) float s_yk[STAGES][BK];
  __shared__ float s_x[ROWS];  // coordinates of the staged rows
  __shared__ float s_y[ROWS];
  __shared__ float s_r[ROWS];
  __shared__ float s_diag[ROWS];
  __shared__ float s_sij[TILE][TILE + 1];  // S on the output tile

  // Upper-triangle block index -> tile pair (bi, bj), bi <= bj.
  const int T = (K + TILE - 1) / TILE;
  int bi = 0;
  int rem = blockIdx.x;
  while (rem >= T - bi) {
    rem -= T - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment group id
  const int t = lane & 3;   // thread in group
  const int kk0 = warp * 8;

  auto staged_row = [&](int q) { return q < TILE ? i0 + q : j0 + q - TILE; };

  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    if constexpr (VEC) {  // K % 4 == 0: a 4-wide chunk is all in or all out
      for (int c = tid; c < ROWS * (BK / 4); c += THREADS) {
        const int q = c / (BK / 4);
        const int kc = (c % (BK / 4)) * 4;
        const int row = staged_row(q);
        const bool ok = row < K && k0 + kc < K;
        cp_async<16>(&s_rows[st][q][kc],
                     ok ? S + static_cast<int64_t>(row) * K + k0 + kc : S,
                     ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < ROWS * BK; c += THREADS) {
        const int q = c / BK;
        const int kc = c % BK;
        const int row = staged_row(q);
        const bool ok = row < K && k0 + kc < K;
        cp_async<4>(&s_rows[st][q][kc],
                    ok ? S + static_cast<int64_t>(row) * K + k0 + kc : S,
                    ok ? 4 : 0);
      }
    }
    if (tid < 2 * BK) {
      const int kc = tid % BK;
      const bool ok = k0 + kc < K;
      const float* src = tid < BK ? x : y;
      cp_async<4>(tid < BK ? &s_xk[st][kc] : &s_yk[st][kc],
                  ok ? src + k0 + kc : src, ok ? 4 : 0);
    }
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) load_tile(p, p);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  // While the first k-tiles land: the staged rows' coordinates and S
  // diagonal, 0 past K (zero traffic there).  Visible after the loop's
  // first barrier.
  for (int q = tid; q < ROWS; q += THREADS) {
    const int row = staged_row(q);
    const bool ok = row < K;
    s_x[q] = ok ? x[row] : 0.0f;
    s_y[q] = ok ? y[row] : 0.0f;
    s_diag[q] = ok ? S[static_cast<int64_t>(row) * K + row] : 0.0f;
  }
  // r: thread tid sums KPT columns of staged row tid / TPR per k-tile.
  const int rq = tid / TPR;
  const int rk0 = (tid % TPR) * KPT;
  const int rrow = staged_row(rq);
  const float qx = rrow < K ? x[rrow] : 0.0f;
  const float qy = rrow < K ? y[rrow] : 0.0f;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  float r_part = 0.0f;
  const int kt_sij = j0 / BK;  // the k-tile holding columns j0 .. j0 + TILE

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    const int ahead = kt + STAGES - 1;
    if (ahead < nk) load_tile(ahead, ahead % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // k-tile kt has landed
    __syncthreads();

#pragma unroll
    for (int u = 0; u < KPT; u += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(&s_rows[st][rq][rk0 + u]);
      const float4 xv = *reinterpret_cast<const float4*>(&s_xk[st][rk0 + u]);
      const float4 yv = *reinterpret_cast<const float4*>(&s_yk[st][rk0 + u]);
      r_part += sv.x * manhattan(qx, qy, xv.x, yv.x);
      r_part += sv.y * manhattan(qx, qy, xv.y, yv.y);
      r_part += sv.z * manhattan(qx, qy, xv.z, yv.z);
      r_part += sv.w * manhattan(qx, qy, xv.w, yv.w);
    }
    if (kt == kt_sij) {  // keep S[i, j] of the output tile for the epilogue
      for (int e = tid; e < TILE * TILE; e += THREADS)
        s_sij[e / TILE][e % TILE] = s_rows[st][e / TILE][j0 - kt * BK + e % TILE];
    }

    float rx[MT][2], ry[MT][2];  // D[i, k] rows: i0 + mt*16 + g (+8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rx[mt][h] = s_x[mt * 16 + g + 8 * h];
        ry[mt][h] = s_y[mt * 16 + g + 8 * h];
      }
    }
    const float xk0 = s_xk[st][kk0 + t];
    const float yk0 = s_yk[st][kk0 + t];
    const float xk1 = s_xk[st][kk0 + t + 4];
    const float yk1 = s_yk[st][kk0 + t + 4];
    uint32_t as[MT][3][4];  // S rows of tile bi, split in three
    uint32_t ad[MT][4];     // D[i, k]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = mt * 16 + g;
      split3(s_rows[st][ra][kk0 + t], as[mt][0][0], as[mt][1][0], as[mt][2][0]);
      split3(s_rows[st][ra + 8][kk0 + t], as[mt][0][1], as[mt][1][1],
             as[mt][2][1]);
      split3(s_rows[st][ra][kk0 + t + 4], as[mt][0][2], as[mt][1][2],
             as[mt][2][2]);
      split3(s_rows[st][ra + 8][kk0 + t + 4], as[mt][0][3], as[mt][1][3],
             as[mt][2][3]);
      ad[mt][0] = dist_u32(rx[mt][0], ry[mt][0], xk0, yk0);
      ad[mt][1] = dist_u32(rx[mt][1], ry[mt][1], xk0, yk0);
      ad[mt][2] = dist_u32(rx[mt][0], ry[mt][0], xk1, yk1);
      ad[mt][3] = dist_u32(rx[mt][1], ry[mt][1], xk1, yk1);
    }
    // Which lower splits of the A fragments hold anything (warp-uniform).
    uint32_t a_mid = 0, a_lo = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_mid |= as[mt][1][e];
        a_lo |= as[mt][2][e];
      }
    }
    const bool use_a_mid = __any_sync(0xffffffffu, a_mid != 0);
    const bool use_a_lo = __any_sync(0xffffffffu, a_lo != 0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int cq = TILE + nt * 8 + g;  // staged row of column j0 + nt*8 + g
      uint32_t bs[3][2];                 // S[k, j] = S[j, k], split in three
      split3(s_rows[st][cq][kk0 + t], bs[0][0], bs[1][0], bs[2][0]);
      split3(s_rows[st][cq][kk0 + t + 4], bs[0][1], bs[1][1], bs[2][1]);
      const float cx = s_x[cq];  // column j0 + nt*8 + g
      const float cy = s_y[cq];
      const uint32_t bd0 = dist_u32(xk0, yk0, cx, cy);  // D[k, j]
      const uint32_t bd1 = dist_u32(xk1, yk1, cx, cy);
      const bool use_b_mid = __any_sync(0xffffffffu, (bs[1][0] | bs[1][1]) != 0);
      const bool use_b_lo = __any_sync(0xffffffffu, (bs[2][0] | bs[2][1]) != 0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A split whose fragments are all zero adds exact zeros: skipped.
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (use_a_lo) mma_tf32(c, as[mt][2], bd0, bd1);
        if (use_a_mid) mma_tf32(c, as[mt][1], bd0, bd1);
        mma_tf32(c, as[mt][0], bd0, bd1);
        if (use_b_lo) mma_tf32(c, ad[mt], bs[2][0], bs[2][1]);
        if (use_b_mid) mma_tf32(c, ad[mt], bs[1][0], bs[1][1]);
        mma_tf32(c, ad[mt], bs[0][0], bs[0][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[e];
      }
    }
    __syncthreads();  // the next iteration refills stage st
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    r_part += __shfl_xor_sync(0xffffffffu, r_part, o);
  if (tid % TPR == 0) s_r[rq] = r_part;

  // Split-K reduction: each warp's partial tile into the staging memory.
  float(*red)[TILE][TILE + 1] =
      reinterpret_cast<float(*)[TILE][TILE + 1]>(&s_rows[0][0][0]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int ra = mt * 16 + g;
      const int cb = nt * 8 + 2 * t;
      red[warp][ra][cb] = acc[mt][nt][0];
      red[warp][ra][cb + 1] = acc[mt][nt][1];
      red[warp][ra + 8][cb] = acc[mt][nt][2];
      red[warp][ra + 8][cb + 1] = acc[mt][nt][3];
    }
  }
  __syncthreads();

  // Fused epilogue from shared memory, in place in red[0] (each element
  // read and written by one thread); elements past K are never stored.
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int a = e / TILE;
    const int b = e % TILE;
    float v = red[0][a][b];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w][a][b];
    const float dij = manhattan(s_x[a], s_y[a], s_x[TILE + b], s_y[TILE + b]);
    red[0][a][b] = v - s_r[a] - s_r[TILE + b] -
                   (s_diag[a] + s_diag[TILE + b] - 2.0f * s_sij[a][b]) * dij;
  }
  __syncthreads();

  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int a = e / TILE;
    const int b = e % TILE;
    if (bi == bj) {  // a partition swapped with itself changes nothing
      if (i0 + a < K && i0 + b < K)
        out[static_cast<int64_t>(i0 + a) * K + i0 + b] =
            a == b ? 0.0f : red[0][min(a, b)][max(a, b)];
    } else {
      if (i0 + a < K && j0 + b < K)
        out[static_cast<int64_t>(i0 + a) * K + j0 + b] = red[0][a][b];
      if (j0 + a < K && i0 + b < K)
        out[static_cast<int64_t>(j0 + a) * K + i0 + b] = red[0][b][a];
    }
  }
}

template <int TILE>
void launch(const float* S, const float* x, const float* y, float* out, int K,
            cudaStream_t stream) {
  const int T = (K + TILE - 1) / TILE;
  const int blocks = T * (T + 1) / 2;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  if (vec) {
    swap_deltas_kernel<TILE, true><<<blocks, THREADS, 0, stream>>>(S, x, y,
                                                                   out, K);
  } else {
    swap_deltas_kernel<TILE, false><<<blocks, THREADS, 0, stream>>>(S, x, y,
                                                                    out, K);
  }
}

}  // namespace

extern "C" int swap_deltas_launch(const float* S, const float* x,
                                  const float* y, float* out, int K,
                                  cudaStream_t stream) {
  if (K > 0) {
    if (K <= 512) {
      launch<16>(S, x, y, out, K, stream);
    } else {
      launch<32>(S, x, y, out, K, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
