// One LIF time step with its synaptic product fused in, one thread per
// destination neuron:
//
//   I[i]   = (sum over fired sources s of w[s -> i]) + drive[i]
//   where refr[i] <= 0:  v[i] <- decay * v[i] + I[i]
//   a neuron fires when v >= threshold; fired neurons get v_reset and
//   refr <- refractory, the rest refr <- max(refr - 1, 0).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_step/kernel.py:38
// (lif_step_pallas / _lif_kernel) together with the dense product
// `last_spikes @ weights` that the reference leaves to XLA outside it
// (src/repro/snn/lif.py:81).  The synapses come in ELL form, destination-
// major: entry c of destination i is (src[c*n + i], w[c*n + i]), valid for
// c < deg[i], in ascending source order, padded to `width` columns; a
// warp's loads of one c are coalesced.  Padding past deg[i] is never
// summed (the first batch may read it).
//
// Order rule.  The current is summed sequentially, in ascending source
// order, from +0.0f, with __fadd_rn: that is the order in which the
// reference's product sums (silent sources add an exact zero), and it is
// the only order that reproduces its raster.  On edge_5120 the interior
// weights are 2.5/25 = 0.1f and ten of them must reach the threshold of
// 1.0 exactly; summed pairwise instead, the raster first differs at step
// 4 (neuron 4098).  So: no warp tree, no atomics in this sum.  The step
// itself rounds as the plain version does (__fmul_rn / __fadd_rn: nvcc
// would contract decay * v + I into one FMA).
//
// The previous step's spikes are read from the raster row t-1 (null at
// t = 0: no spikes); v and refr are updated in place (each thread owns its
// neuron, so v_in may alias v_out), and the step's spikes are written as
// uint8 into raster row t.  With deg null the kernel is the plain step on
// a given current (lif_step on CUDA tensors).
//
// Bound on an H100: memory, ~0.9 MB a step on edge_5120 (95,788 synapses
// x 8 B, deg, the previous raster row, the drive row, v/refr read and
// written, the raster row) — ~0.27 us at 3.35 TB/s.  What sets its time
// is latency: a thread's ~50 synapses are a chain of dependent loads
// (source, then that source's spike) and adds.  So each thread requests
// its state and its first kBatch synapses at once — all sources and
// weights of a batch in flight together — then all their spikes (the 5 KB
// spike row stays in L1/L2), then adds in order: two rounds of L2 latency
// a batch, eight for 50 synapses instead of ~100.  64 threads a block
// spread N = 5,120 over 80 SMs.  Measured and dropped
// (tools/probe_lif_link.py): copying the spike row into shared memory
// first (80 blocks reading the same 5 KB wait on the same L2 lines), and
// loading the next batch during this one's lookups (no faster).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kBatch = 16;  // synapses a thread has in flight

__global__ void lif_step_kernel(const int32_t* __restrict__ syn_src,
                                const float* __restrict__ syn_w,
                                const int32_t* __restrict__ syn_deg,
                                const uint8_t* __restrict__ prev,
                                const float* __restrict__ drive,
                                const float* v_in, const int32_t* refr_in,
                                float* v_out, int32_t* refr_out,
                                uint8_t* __restrict__ fired_out, int n,
                                int width, float decay, float threshold,
                                float v_reset, int refractory) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool synapses = syn_deg != nullptr && prev != nullptr;
  // The first batch is requested together with the state and the count
  // (its loads stay inside the padded ELL columns), so no request waits
  // on another.
  int32_t s[kBatch];
  float w[kBatch];
  const int first = synapses ? (width < kBatch ? width : kBatch) : 0;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int64_t e = static_cast<int64_t>(j) * n + i;
    s[j] = j < first ? syn_src[e] : 0;
    w[j] = j < first ? syn_w[e] : 0.0f;
  }
  const int d = synapses ? syn_deg[i] : 0;
  const float drive_i = drive[i];
  const float vi = v_in[i];
  const int32_t ri = refr_in[i];
  float acc = 0.0f;
  for (int c0 = 0; c0 < d; c0 += kBatch) {
    // All the batch's spike lookups first, then the adds in order.
    unsigned hit = 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      hit |= (c0 + j < d && prev[s[j]]) ? 1u << j : 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)  // ascending sources
      if (hit >> j & 1u) acc = __fadd_rn(acc, w[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // the next batch
      const int c = c0 + kBatch + j;
      const int64_t e = static_cast<int64_t>(c) * n + i;
      s[j] = c < d ? syn_src[e] : 0;
      w[j] = c < d ? syn_w[e] : 0.0f;
    }
  }
  const float cur = __fadd_rn(acc, drive_i);
  const bool active = ri <= 0;
  const float v2 = active ? __fadd_rn(__fmul_rn(decay, vi), cur) : vi;
  const bool fired = active && (v2 >= threshold);
  v_out[i] = fired ? v_reset : v2;
  refr_out[i] = fired ? refractory : (ri - 1 > 0 ? ri - 1 : 0);
  fired_out[i] = fired ? 1 : 0;
}

}  // namespace

extern "C" int lif_step_launch(const int32_t* syn_src, const float* syn_w,
                               const int32_t* syn_deg, const uint8_t* prev,
                               const float* drive, const float* v_in,
                               const int32_t* refr_in, float* v_out,
                               int32_t* refr_out, uint8_t* fired_out, int n,
                               int width, float decay, float threshold,
                               float v_reset, int refractory,
                               cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    lif_step_kernel<<<blocks, kThreads, 0, stream>>>(
        syn_src, syn_w, syn_deg, prev, drive, v_in, refr_in, v_out, refr_out,
        fired_out, n, width, decay, threshold, v_reset, refractory);
  }
  return static_cast<int>(cudaGetLastError());
}
