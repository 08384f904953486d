// LIF membrane update + spike detect, one thread per neuron.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_step/kernel.py
// (lif_step_pallas / _lif_kernel).  Where refr <= 0: v <- decay * v + I;
// a neuron fires when v >= threshold; fired neurons get v_reset and
// refr <- refractory, the rest refr <- max(refr - 1, 0).
//
// Bound on an H100: memory.  Per launch it reads v, refr, I (12 B/neuron)
// and writes v', refr', fired (9 B/neuron) — ~108 KB at N = 5120, about
// 32 ns at 3.35 TB/s, far below the launch latency that actually limits
// it.  The design keeps every neuron's state update in one pass (no
// separate where/compare kernels) and masks the tail with a bounds check
// instead of the TPU kernel's 2**30-refractory padding.
//
// Rounding: decay * v + I must round twice, as the plain PyTorch version
// (two elementwise kernels) does.  nvcc would contract it into one FMA by
// default, so a neuron at threshold could fire on one path and not the
// other; __fmul_rn / __fadd_rn forbid the contraction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lif_step_kernel(const float* __restrict__ v,
                                const int32_t* __restrict__ refr,
                                const float* __restrict__ cur,
                                float* __restrict__ v_out,
                                int32_t* __restrict__ refr_out,
                                uint8_t* __restrict__ fired_out,
                                int n, float decay, float threshold,
                                float v_reset, int refractory) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float vi = v[i];
  const int32_t ri = refr[i];
  const bool active = ri <= 0;
  const float v2 = active ? __fadd_rn(__fmul_rn(decay, vi), cur[i]) : vi;
  const bool fired = active && (v2 >= threshold);
  v_out[i] = fired ? v_reset : v2;
  refr_out[i] = fired ? refractory : (ri - 1 > 0 ? ri - 1 : 0);
  fired_out[i] = fired ? 1 : 0;
}

}  // namespace

extern "C" int lif_step_launch(const float* v, const int32_t* refr,
                               const float* cur, float* v_out,
                               int32_t* refr_out, uint8_t* fired_out, int n,
                               float decay, float threshold, float v_reset,
                               int refractory, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    lif_step_kernel<<<blocks, threads, 0, stream>>>(
        v, refr, cur, v_out, refr_out, fired_out, n, decay, threshold,
        v_reset, refractory);
  }
  return static_cast<int>(cudaGetLastError());
}
