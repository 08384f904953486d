// The queued unicast replay's two tier-1 screens, one block a window.
//
// Packets are window-sorted records, one int32 each, (src << 16) | dst
// (cores row-major on a W x H mesh), with their injection cycles; window w
// owns records woff[w] .. woff[w+1]-1.  For each window:
//
//   (a) loads[l]  = packets whose XY route crosses directed link l
//                   (the nocsim/xy.py link id layout);
//   (b) past[p]   = p's route crosses a link with loads[l] > cap;
//   (c) bucket[c, l] = past packets crossing l at cycle c = inject + step
//                   under the unobstructed schedule (step: the link's
//                   0-based place on the route);
//   (d) bad       = some bucket[c, l] > cap;
//   (e) stepped[p] = past[p] && bad.
//
// Out come flags[p] = kPast (1) | kStepped (2), the per-link totals over
// all windows, and three counts: (window, link) pairs above cap, past
// packets, bad windows.
//
// Replaces no TPU kernel.  The reference screens on the host: a numpy
// route expansion (src/repro/nocsim/replay.py), then a membership test of
// every traversal against the overloaded pairs and a (window, cycle, link)
// histogram of the past packets' schedule.  That expansion was most of the
// replay's host time, to feed a device stepper that rebuilds routes on its
// own; here each route is walked in registers and nothing is expanded.
//
// Design.  A window's loads live in shared memory (one int32 bin a link:
// 960 bins on 16 x 16), as in link_loads.cu; within a warp, records with
// equal routes (and, for the schedule, equal injection cycles) are merged
// with __match_any_sync so the group's leader walks its route once for the
// group.  The schedule's buckets are packed counters in shared memory, 8
// bits each while cap < 255 (16 or 32 above): only "count > cap" is read,
// and the first add that carries out of a counter has taken it above cap
// already, so a carry never hides an overload nor makes one that is not
// there.  Once a window is known bad no thread adds to its buckets.  A
// window whose cycles do not fit the bucket area is screened in passes over
// cycle ranges.  Integer counts only: the result does not depend on the
// order in which threads run.
//
// Bound on an H100: memory, and it is small.  The records and the injection
// cycles are read (8 B a packet, plus woff), the flags written (1 B a
// packet) and the per-link totals: ~41 MB on the replay cell's 4.58 M
// packets in 420 windows, ~12 us at 3.35 TB/s.  The blocks read their
// window again from L2 for (b) and (e).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBucketBytes = 64 * 1024;  // a block's schedule buckets
constexpr uint8_t kPast = 1, kStepped = 2;

struct Mesh {
  int W, H, w_base, s_base, n_base;
};

__device__ __forceinline__ int route_hops(const Mesh& m, int key) {
  const int s = key >> 16, d = key & 0xffff;
  return abs(s % m.W - d % m.W) + abs(s / m.W - d / m.W);
}

// Calls f(link, step) along the XY route of record key, in traversal order,
// and stops where f returns true; returns whether it stopped.
template <class F>
__device__ __forceinline__ bool walk(const Mesh& m, int key, F f) {
  const int s = key >> 16, d = key & 0xffff;
  const int sx = s % m.W, sy = s / m.W, dx = d % m.W, dy = d / m.W;
  int j = 0;
  for (int x = sx; x < dx; ++x, ++j)
    if (f(sy * (m.W - 1) + x, j)) return true;
  for (int x = sx; x > dx; --x, ++j)
    if (f(m.w_base + sy * (m.W - 1) + x - 1, j)) return true;
  for (int y = sy; y < dy; ++y, ++j)
    if (f(m.s_base + dx * (m.H - 1) + y, j)) return true;
  for (int y = sy; y > dy; --y, ++j)
    if (f(m.n_base + dx * (m.H - 1) + y - 1, j)) return true;
  return false;
}

// Packed (cycle, link) counters of `bits` bits for cycles c0 .. c0+cycles-1.
struct Buckets {
  uint32_t* words;
  int bits, nl, c0, cycles, cap;

  // Adds c to bucket (cycle, link); true where that takes it above cap.
  __device__ __forceinline__ bool add(int cycle, int link, uint32_t c) const {
    const int rel = cycle - c0;
    if (rel < 0 || rel >= cycles) return false;
    const uint32_t bit = static_cast<uint32_t>(rel * nl + link) * bits;
    const uint32_t off = bit & 31;
    const uint32_t old = atomicAdd(&words[bit >> 5], c << off);
    const uint32_t mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1;
    return static_cast<uint64_t>((old >> off) & mask) + c > cap;
  }
};

__global__ void __launch_bounds__(kThreads)
replay_screen_kernel(const int32_t* __restrict__ woff,
                     const int32_t* __restrict__ rec,
                     const int32_t* __restrict__ inject, int n_win, Mesh m,
                     int nl, int cap, int bits, int cycles_per_pass,
                     uint8_t* __restrict__ flags,
                     unsigned long long* __restrict__ per_link,
                     unsigned long long* __restrict__ counts) {
  extern __shared__ uint32_t smem[];
  int32_t* hist = reinterpret_cast<int32_t*>(smem);  // nl bins
  uint32_t* words = smem + nl;                        // the buckets
  const int n_words = (cycles_per_pass * nl * bits + 31) / 32;
  __shared__ int s_end, s_past, s_hot;
  __shared__ volatile int s_bad;  // read early by threads to skip adds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;

  for (int w = blockIdx.x; w < n_win; w += gridDim.x) {
    const int lo = woff[w], hi = woff[w + 1];
    for (int i = threadIdx.x; i < nl + n_words; i += kThreads) smem[i] = 0;
    if (threadIdx.x == 0) {
      s_end = s_past = s_hot = 0;
      s_bad = 0;
    }
    __syncthreads();

    // (a) Loads, and the cycle after the window's last unobstructed hop.
    int end = 0;
    for (int base = lo + 32 * warp; base < hi; base += kThreads) {
      const int r = base + lane;
      const int key = r < hi ? rec[r] : -1;
      const unsigned group = __match_any_sync(full, key);
      if (r < hi) {
        end = max(end, inject[r] + route_hops(m, key));
        if (lane == __ffs(group) - 1) {
          const int c = __popc(group);
          walk(m, key, [&](int l, int) {
            atomicAdd(&hist[l], c);
            return false;
          });
        }
      }
    }
    atomicMax(&s_end, end);
    __syncthreads();
    int hot = 0;
    for (int i = threadIdx.x; i < nl; i += kThreads) {
      const int v = hist[i];
      if (v != 0) atomicAdd(&per_link[i], static_cast<unsigned long long>(v));
      hot += v > cap;
    }
    atomicAdd(&s_hot, hot);
    end = s_end;

    // (b) with the first pass of (c): flag each packet, and add the past
    // ones to the buckets of cycles 0 .. cycles_per_pass-1.
    Buckets b{words, bits, nl, 0, cycles_per_pass, cap};
    bool over = false;
    int past = 0;
    for (int base = lo + 32 * warp; base < hi; base += kThreads) {
      const int r = base + lane;
      const int key = r < hi ? rec[r] : -1;
      const int inj = r < hi ? inject[r] : -1;
      const unsigned group = __match_any_sync(
          full, (static_cast<unsigned long long>(static_cast<uint32_t>(key))
                 << 32) | static_cast<uint32_t>(inj));
      const int leader = __ffs(group) - 1;
      bool hit = false;
      if (r < hi && lane == leader) {
        hit = walk(m, key, [&](int l, int) { return hist[l] > cap; });
        if (hit && !s_bad) {
          const uint32_t c = __popc(group);
          walk(m, key, [&](int l, int j) {
            over |= b.add(inj + j, l, c);
            return false;
          });
          if (over) s_bad = 1;
        }
      }
      hit = __shfl_sync(full, hit, leader);
      if (r < hi) {
        flags[r] = hit ? kPast : 0;
        past += hit;
      }
    }
    atomicAdd(&s_past, past);
    bool bad = __syncthreads_or(over);

    // (c) continued: further cycle ranges, while the window is not bad.
    for (b.c0 = cycles_per_pass; !bad && b.c0 < end; b.c0 += cycles_per_pass) {
      for (int i = threadIdx.x; i < n_words; i += kThreads) words[i] = 0;
      __syncthreads();
      for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
        const int inj = inject[r];
        if (!(flags[r] & kPast) || s_bad || inj >= b.c0 + cycles_per_pass ||
            inj + route_hops(m, rec[r]) <= b.c0)
          continue;
        walk(m, rec[r], [&](int l, int j) {
          over |= b.add(inj + j, l, 1);
          return false;
        });
        if (over) s_bad = 1;
      }
      bad = __syncthreads_or(over);
    }

    // (e) Each thread marks the packets it flagged in (b).
    if (bad) {
      for (int base = lo + 32 * warp; base < hi; base += kThreads) {
        const int r = base + lane;
        if (r < hi && flags[r]) flags[r] = kPast | kStepped;
      }
    }
    if (threadIdx.x == 0) {
      atomicAdd(&counts[0], static_cast<unsigned long long>(s_hot));
      atomicAdd(&counts[1], static_cast<unsigned long long>(s_past));
      if (bad) atomicAdd(&counts[2], 1ull);
    }
    __syncthreads();  // shared memory is zeroed again for the next window
  }
}

}  // namespace

// totals: nl per-link totals, then the three counts (int64, zeroed here).
extern "C" int replay_screen_launch(const int32_t* woff, const int32_t* rec,
                                    const int32_t* inject, uint8_t* flags,
                                    int64_t* totals, int n_win, int W, int H,
                                    int cap, cudaStream_t stream) {
  const int nl = 2 * (W - 1) * H + 2 * W * (H - 1);
  cudaError_t err = cudaMemsetAsync(
      totals, 0, static_cast<size_t>(nl + 3) * sizeof(int64_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_win > 0) {
    const int bits = cap < 255 ? 8 : (cap < 65535 ? 16 : 32);
    int cycles = kBucketBytes * 8 / (nl * bits);
    if (cycles < 1) cycles = 1;
    const int n_words = (cycles * nl * bits + 31) / 32;
    const size_t smem = static_cast<size_t>(nl + n_words) * sizeof(uint32_t);
    err = cudaFuncSetAttribute(replay_screen_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    Mesh m{W, H, (W - 1) * H, 2 * (W - 1) * H, 2 * (W - 1) * H + W * (H - 1)};
    const int blocks = n_win < 132 * 8 ? n_win : 132 * 8;
    auto* out = reinterpret_cast<unsigned long long*>(totals);
    replay_screen_kernel<<<blocks, kThreads, smem, stream>>>(
        woff, rec, inject, n_win, m, nl, cap, bits, cycles, flags, out,
        out + nl);
  }
  return static_cast<int>(cudaGetLastError());
}
