// Fused LIF neuron-pool step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_step/kernel.py::_kernel
// (lif_step_tiles).  Same function, bit for bit, as
// src/repro_torch/kernels/lif_step/ref.py::lif_step_units:
//   s = clip(spikes, +-511); syn = W.s + extra;
//   v1 = max(v + (refrac == 0 ? syn : 0) - leak, 0);
//   fired = refrac == 0 && v1 >= thresh;
//   v' = fired ? 0 : v1;  refrac' = fired ? rp : max(refrac - 1, 0).
//
// Design.  The TPU kernel transposes the weights to (U, C, R), pads R to
// 128 and contracts in fp32 on the MXU.  Here the weights stay (U, R, C)
// row-major and one warp owns one neuron row: a row's C <= 256 int8 weights
// are contiguous, so the warp's loads are coalesced.  The unit's clipped
// spike vector is staged once per block in shared memory as int32, the
// contraction accumulates in int32 (exact, no range argument needed), a
// __shfl_xor_sync butterfly reduces the warp, and lane 0 applies leak,
// threshold, reset and refractory.  Ragged R and C edges are masked here.
// Every row 0..R-1 is computed, as the reference does: the caller selects
// rows afterwards.  Integer sums wrap like the reference's int32 tensors
// (unsigned arithmetic, so the wrap is defined behaviour).
//
// Bound.  The step moves U*R*C weight bytes plus about U*(4C + 20R) state
// bytes: ~573 KB at U=8, R=C=256, i.e. ~0.17 us at 3.35 TB/s, and does
// 2*U*R*C integer operations (~1 MOP, far below any compute bound).  A
// launch costs microseconds, so at the VP's shapes the launch dominates;
// fusing the tick into the step or a CUDA graph is the lever, not this body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpikeSat = 511;
constexpr int kWarpsPerBlock = 8;

__global__ void lif_step_kernel(const int8_t* __restrict__ w,
                                const int32_t* __restrict__ spikes,
                                const int32_t* __restrict__ v,
                                const int32_t* __restrict__ refrac,
                                const int32_t* __restrict__ thresh,
                                const int32_t* __restrict__ leak,
                                const int32_t* __restrict__ rp,
                                const int32_t* __restrict__ extra,
                                int32_t* __restrict__ v_out,
                                int32_t* __restrict__ r_out,
                                int32_t* __restrict__ fired_out,
                                int R, int C) {
  extern __shared__ int32_t s_sh[];  // the unit's clipped spike counts (C)
  const int u = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int s = spikes[(size_t)u * C + c];
    s_sh[c] = min(max(s, -kSpikeSat), kSpikeSat);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= R) return;  // whole warp leaves together: the shuffles stay full
  const size_t i = (size_t)u * R + row;
  const int8_t* wrow = w + i * C;
  unsigned acc = 0;
  for (int c = lane; c < C; c += 32) acc += (unsigned)((int)wrow[c] * s_sh[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;

  if (extra != nullptr) acc += (unsigned)extra[i];
  const int r = refrac[i];
  const bool active = r == 0;
  int v1 = (int)((unsigned)v[i] + (active ? acc : 0u) - (unsigned)leak[u]);
  v1 = max(v1, 0);
  const bool fired = active && v1 >= thresh[u];
  v_out[i] = fired ? 0 : v1;
  r_out[i] = fired ? rp[u] : max((int)((unsigned)r - 1u), 0);
  fired_out[i] = fired ? 1 : 0;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() after the launch (0 on
// success).  ``extra`` may be null.  Shapes: w (U, R, C) int8; spikes (U, C);
// v, refrac, extra, outputs (U, R); thresh, leak, rp (U,) — all int32 and
// contiguous.  Needs C * 4 bytes of shared memory and U <= 65535.
extern "C" int lif_step_launch(const void* w, const void* spikes, const void* v,
                               const void* refrac, const void* thresh,
                               const void* leak, const void* rp,
                               const void* extra, void* v_out, void* r_out,
                               void* fired_out, int U, int R, int C,
                               void* stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock, U);
  const dim3 block(32 * kWarpsPerBlock);
  const size_t shmem = (size_t)C * sizeof(int32_t);
  lif_step_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int32_t*)spikes, (const int32_t*)v,
      (const int32_t*)refrac, (const int32_t*)thresh, (const int32_t*)leak,
      (const int32_t*)rp, (const int32_t*)extra, (int32_t*)v_out,
      (int32_t*)r_out, (int32_t*)fired_out, R, C);
  return (int)cudaGetLastError();
}
