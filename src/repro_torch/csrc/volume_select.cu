// Conflict-free mover selection of a volume refinement batch: the slot
// contention and the iterated Luby rounds of refine_vec's select_movers
// (volume branch) in one cooperative launch a call.
//
// Replaces no TPU kernel: the reference selects its movers in numpy
// (src/repro/core/refine_vec.py, select_movers), and so does the port on
// the CPU, on sharded levels and on levels without a live Φ table.  Added
// because that host selection was the largest step of the volume refiner's
// loop on the card: two whole-table bincounts a call and, in plateau
// escapes, four Luby rounds of scatter-max and fancy-indexed passes over
// up to ~110k contended (candidate, hyperedge, side) pairs, while the
// vertex -> hyperedge CSR and Φ are already resident for the D* kernel.
//
// What it computes, for candidates i with vertex cand[i], own column
// own[i], target column target[i] and priority pri[i] (distinct, > 0):
// every incident hyperedge e of cand[i] gives two keys (slots) e*k + own
// (a leaver) and e*k + target.  A slot is contended when
//     touchers > 1  and  (Φ < 2  or  Φ - leavers < 2)
// counted over all candidates.  A candidate with no contended slot is
// chosen outright.  The rest enter up to `rounds` rounds: a live candidate
// is excluded if one of its contended slots is used, loses if a live
// candidate with a higher priority shares one of its contended slots
// (excluded candidates still count in that maximum), wins otherwise; the
// winners' contended slots become used, the losers that were not excluded
// stay live.  The result is exact integer logic: counts and maxima do not
// depend on the order in which the atomics land, so the chosen set equals
// the host's bit for bit.
//
// Design: one warp a candidate (grid-stride), its lanes striding over the
// candidate's incidence list; phases separated by grid syncs (a
// cooperative launch of at most as many 256-thread blocks as are resident
// at once, and no more than one warp a candidate).  The slot state lives
// on the card for a level and is zero at rest, so no call passes over all
// E*k slots:
//   cnt  (u64)  touchers in the low, leavers in the high 32 bits; added in
//               phase 1, read in phase 2, zeroed at the call's own keys in
//               the phase after;
//   cont (i32)  = call where the slot is contended in this call;
//   used (i32)  = call where a winner of this call holds the slot;
//   rank (u64)  (stamp << 32) | pri with stamp = call * rounds + round, an
//               atomicMax: a newer stamp outranks whatever an earlier round
//               or call left, so nothing is ever zeroed.
// Per-call counters (contended keys, live candidates at each round's start)
// are zeroed by block 0 in phase 1 and read only after a grid sync.
// Mutable slot state is read with __ldcg (L2), never through L1, since
// later rounds read what earlier rounds of this launch wrote.
//
// Bound on an H100: latency, not bandwidth.  An escape call of the
// edge_5120 cell (~2,000 candidates, ~66k pairs) touches ~132k slots a few
// times: ~24 B a key in phases 1-2 and ~16 B a contended key a round, a
// few MB a call (~1-3 us at 3.35 TB/s), all of it L2-resident; a positive
// call (~40 candidates, ~1,500 pairs) is ~100 kB.  What a call costs is
// the launch, one L2 round trip per list stride a phase and 2-10 grid
// syncs, a few to tens of microseconds.
//
// Output: out[0..3] the contended key count (int32), out[4..7] the rounds
// run (int32), out[8 + i] 1 where candidate i is chosen, else 0.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;  // candidates a block holds at once
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long LEAVER = 1ull | (1ull << 32);

enum : unsigned char { OUT = 0, CHOSEN = 1, LIVE = 2 };

struct Args {
  const int* vxadj;
  const int* vedges;
  const int* phi;
  const int* cand;
  const int* own;
  const int* target;
  const int* pri;
  unsigned long long* cnt;
  unsigned long long* rank;
  int* used;
  int* cont;
  int* ctr;  // [0] contended keys, [1 + r] live at the start of round r
  unsigned char* out;
  int nc, k, call, rounds;
};

__device__ __forceinline__ unsigned char warp_status(const Args& a, int i,
                                                     int lane) {
  unsigned char s = lane == 0 ? a.out[8 + i] : 0;
  return static_cast<unsigned char>(__shfl_sync(FULL, s, 0));
}

// Phase A of a round: exclusion by a used slot and the per-slot maximum of
// (stamp, priority) over the live candidates; with `zero`, every
// candidate's counters go back to zero as well (after phase 2 read them).
__device__ __forceinline__ void phase_a(const Args& a, int r, bool zero, int gwarp,
                        int nwarps, int lane) {
  const unsigned long long stamp =
      (static_cast<unsigned long long>(a.call) * a.rounds + r) << 32;
  for (int i = gwarp; i < a.nc; i += nwarps) {
    const bool live = warp_status(a, i, lane) == LIVE;
    if (!live && !zero) continue;
    const int v = a.cand[i];
    const long long o = a.own[i], t = a.target[i];
    const unsigned long long mine = stamp | static_cast<unsigned>(a.pri[i]);
    const int end = a.vxadj[v + 1];
    bool excl = false;
    for (int j = a.vxadj[v] + lane; j < end; j += 32) {
      const long long base = static_cast<long long>(a.vedges[j]) * a.k;
      const long long keys[2] = {base + o, base + t};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (zero) a.cnt[keys[s]] = 0;
        if (live && __ldcg(a.cont + keys[s]) == a.call) {
          excl |= __ldcg(a.used + keys[s]) == a.call;
          atomicMax(a.rank + keys[s], mine);
        }
      }
    }
    if (live && __any_sync(FULL, excl) && lane == 0) a.out[8 + i] = OUT;
  }
}

// Phase B of a round: a live candidate beaten on one of its contended
// slots stays live (or drops out after the last round); the others win
// and mark their contended slots used.
__device__ __forceinline__ void phase_b(const Args& a, int r, int gwarp, int nwarps,
                        int lane) {
  const unsigned long long stamp =
      (static_cast<unsigned long long>(a.call) * a.rounds + r) << 32;
  for (int i = gwarp; i < a.nc; i += nwarps) {
    if (warp_status(a, i, lane) != LIVE) continue;
    const int v = a.cand[i];
    const long long o = a.own[i], t = a.target[i];
    const unsigned long long mine = stamp | static_cast<unsigned>(a.pri[i]);
    const int beg = a.vxadj[v], end = a.vxadj[v + 1];
    bool lost = false;
    for (int j = beg + lane; j < end; j += 32) {
      const long long base = static_cast<long long>(a.vedges[j]) * a.k;
      const long long keys[2] = {base + o, base + t};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (__ldcg(a.cont + keys[s]) == a.call)
          lost |= __ldcg(a.rank + keys[s]) > mine;
      }
    }
    if (__any_sync(FULL, lost)) {
      if (lane == 0) {
        if (r + 1 < a.rounds) atomicAdd(a.ctr + 2 + r, 1);
        else a.out[8 + i] = OUT;
      }
      continue;
    }
    for (int j = beg + lane; j < end; j += 32) {
      const long long base = static_cast<long long>(a.vedges[j]) * a.k;
      const long long keys[2] = {base + o, base + t};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (__ldcg(a.cont + keys[s]) == a.call) a.used[keys[s]] = a.call;
      }
    }
    if (lane == 0) a.out[8 + i] = CHOSEN;
  }
}

__global__ void __launch_bounds__(THREADS) volume_select_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5);
  const int nwarps = gridDim.x * WARPS;

  // Phase 1: touchers and leavers per slot.
  if (blockIdx.x == 0 && threadIdx.x <= a.rounds) a.ctr[threadIdx.x] = 0;
  for (int i = gwarp; i < a.nc; i += nwarps) {
    const int v = a.cand[i];
    const long long o = a.own[i], t = a.target[i];
    const int end = a.vxadj[v + 1];
    for (int j = a.vxadj[v] + lane; j < end; j += 32) {
      const long long base = static_cast<long long>(a.vedges[j]) * a.k;
      atomicAdd(a.cnt + base + o, LEAVER);
      atomicAdd(a.cnt + base + t, 1ull);
    }
  }
  grid.sync();

  // Phase 2: contended slots; a candidate with none is chosen outright.
  for (int i = gwarp; i < a.nc; i += nwarps) {
    const int v = a.cand[i];
    const long long o = a.own[i], t = a.target[i];
    const int end = a.vxadj[v + 1];
    int contended = 0;
    for (int j = a.vxadj[v] + lane; j < end; j += 32) {
      const long long base = static_cast<long long>(a.vedges[j]) * a.k;
      const long long keys[2] = {base + o, base + t};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const unsigned long long w = __ldcg(a.cnt + keys[s]);
        const int touchers = static_cast<int>(w & 0xffffffffull);
        const int leavers = static_cast<int>(w >> 32);
        const int p = a.phi[keys[s]];
        if (touchers > 1 && (p < 2 || p - leavers < 2)) {
          a.cont[keys[s]] = a.call;
          ++contended;
        }
      }
    }
    const int total = __reduce_add_sync(FULL, contended);
    if (lane == 0) {
      a.out[8 + i] = total ? LIVE : CHOSEN;
      if (total) {
        atomicAdd(a.ctr, total);
        atomicAdd(a.ctr + 1, 1);
      }
    }
  }
  grid.sync();

  // The rounds; round 0's phase A also zeroes the counters, and runs even
  // where no candidate is live.
  int live = __ldcg(a.ctr + 1);
  phase_a(a, 0, true, gwarp, nwarps, lane);
  int ran = 0;
  for (int r = 0; r < a.rounds && live > 0; ++r) {
    if (r > 0) phase_a(a, r, false, gwarp, nwarps, lane);
    grid.sync();
    phase_b(a, r, gwarp, nwarps, lane);
    ran = r + 1;
    if (r + 1 < a.rounds) {
      grid.sync();
      live = __ldcg(a.ctr + 2 + r);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* head = reinterpret_cast<int*>(a.out);
    head[0] = __ldcg(a.ctr);
    head[1] = ran;
  }
}

}  // namespace

extern "C" int volume_select_launch(
    const int* vxadj, const int* vedges, const int* phi, const int* cand,
    const int* own, const int* target, const int* pri,
    unsigned long long* cnt, unsigned long long* rank, int* used, int* cont,
    int* ctr, unsigned char* out, int nc, int k, int call, int rounds,
    cudaStream_t stream) {
  // Blocks resident at once on the current device: a cooperative launch
  // may not ask for more.  Looked up once a device.
  static int resident[64] = {0};
  if (rounds < 0 || rounds >= THREADS) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, volume_select_kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * per_sm;
  }
  const int want = (nc + WARPS - 1) / WARPS;
  const int blocks = want < 1 ? 1 : (want < resident[dev] ? want : resident[dev]);
  Args a{vxadj, vedges, phi, cand, own, target, pri, cnt, rank, used, cont,
         ctr, out, nc, k, call, rounds};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(volume_select_kernel), dim3(blocks),
      dim3(THREADS), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
