// Fused LIF neuron-pool step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels src/repro/kernels/lif_step/kernel.py::_kernel
// and ::_kernel_faults (both reached through lif_step_tiles).  Same function,
// bit for bit, as src/repro_torch/kernels/lif_step/ref.py::lif_step_units:
//   s = clip(spikes, +-511); syn = W.s + extra;
//   v1 = max(v + (refrac == 0 ? syn : 0) - leak, 0);
//   fired = refrac == 0 && v1 >= thresh;
//   v' = fired ? 0 : v1;  refrac' = fired ? rp : max(refrac - 1, 0).
// The fault variant (kFaults) reads W as (W & f_and) ^ f_xor, gates dead
// neurons out of integration and firing with v' pinned to 0, and fires at
// max(thresh + dth, 1).  Each fault input may be null, meaning neutral
// (f_and = -1, f_xor = 0, alive, no drift), so neuron-only faults need no
// (U, R, C) masks; all four null equals the clean step bit for bit.  The
// fault-free instantiation (kFaults = false) is the clean kernel unchanged.
//
// Design.  The TPU kernel transposes the weights to (U, C, R), pads R to
// 128 and contracts in fp32 on the MXU.  Here the weights stay (U, R, C)
// row-major and one warp owns one neuron row: a row's C <= 256 int8 weights
// are contiguous, so the warp's loads are coalesced (and so are the masks',
// which share the weights' layout).  The unit's clipped spike vector is
// staged once per block in shared memory as int32, the contraction
// accumulates in int32 (exact, no range argument needed), a __shfl_xor_sync
// butterfly reduces the warp, and lane 0 applies leak, threshold, reset and
// refractory (and the dead gate and the drift).  Ragged R and C edges are
// masked here.  Every row 0..R-1 is computed, as the reference does: the
// caller selects rows afterwards.  Integer sums wrap like the reference's
// int32 tensors (unsigned arithmetic, so the wrap is defined behaviour).
// int8 masks are applied to the sign-extended int8 weight: & and ^ of two
// sign-extended bytes are the sign-extended byte result.
//
// Bound.  The clean step moves U*R*C weight bytes plus about U*(4C + 20R)
// state bytes: ~573 KB at U=8, R=C=256, i.e. ~0.17 us at 3.35 TB/s, and does
// 2*U*R*C integer operations (~1 MOP, far below any compute bound).  The
// fault step adds 2*U*R*C mask bytes and U*5R bytes of dead/dth (~0.51 us).
// A launch costs microseconds, so at the VP's shapes the launch dominates;
// fusing the tick into the step or a CUDA graph is the lever, not this body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpikeSat = 511;
constexpr int kWarpsPerBlock = 8;

template <bool kFaults>
__global__ void lif_step_kernel(const int8_t* __restrict__ w,
                                const int32_t* __restrict__ spikes,
                                const int32_t* __restrict__ v,
                                const int32_t* __restrict__ refrac,
                                const int32_t* __restrict__ thresh,
                                const int32_t* __restrict__ leak,
                                const int32_t* __restrict__ rp,
                                const int32_t* __restrict__ extra,
                                const int8_t* __restrict__ f_and,
                                const int8_t* __restrict__ f_xor,
                                const uint8_t* __restrict__ dead,
                                const int32_t* __restrict__ dth,
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
  if constexpr (kFaults) {
    const int8_t* arow = f_and == nullptr ? nullptr : f_and + i * C;
    const int8_t* xrow = f_xor == nullptr ? nullptr : f_xor + i * C;
    for (int c = lane; c < C; c += 32) {
      int wc = wrow[c];
      if (arow != nullptr) wc &= arow[c];
      if (xrow != nullptr) wc ^= xrow[c];
      acc += (unsigned)(wc * s_sh[c]);
    }
  } else {
    for (int c = lane; c < C; c += 32) acc += (unsigned)((int)wrow[c] * s_sh[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;

  if (extra != nullptr) acc += (unsigned)extra[i];
  const int r = refrac[i];
  bool active = r == 0;
  bool is_dead = false;
  int th = thresh[u];
  if constexpr (kFaults) {
    if (dead != nullptr) is_dead = dead[i] != 0;
    active = active && !is_dead;
    if (dth != nullptr) th = max((int)((unsigned)th + (unsigned)dth[i]), 1);
  }
  int v1 = (int)((unsigned)v[i] + (active ? acc : 0u) - (unsigned)leak[u]);
  v1 = max(v1, 0);
  const bool fired = active && v1 >= th;
  v_out[i] = (fired || is_dead) ? 0 : v1;
  r_out[i] = fired ? rp[u] : max((int)((unsigned)r - 1u), 0);
  fired_out[i] = fired ? 1 : 0;
}

template <bool kFaults>
int launch(const void* w, const void* spikes, const void* v, const void* refrac,
           const void* thresh, const void* leak, const void* rp, const void* extra,
           const void* f_and, const void* f_xor, const void* dead, const void* dth,
           void* v_out, void* r_out, void* fired_out, int U, int R, int C,
           void* stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock, U);
  const dim3 block(32 * kWarpsPerBlock);
  const size_t shmem = (size_t)C * sizeof(int32_t);
  lif_step_kernel<kFaults><<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int32_t*)spikes, (const int32_t*)v,
      (const int32_t*)refrac, (const int32_t*)thresh, (const int32_t*)leak,
      (const int32_t*)rp, (const int32_t*)extra, (const int8_t*)f_and,
      (const int8_t*)f_xor, (const uint8_t*)dead, (const int32_t*)dth,
      (int32_t*)v_out, (int32_t*)r_out, (int32_t*)fired_out, R, C);
  return (int)cudaGetLastError();
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
  return launch<false>(w, spikes, v, refrac, thresh, leak, rp, extra, nullptr,
                       nullptr, nullptr, nullptr, v_out, r_out, fired_out, U, R,
                       C, stream);
}

// The fault variant: as lif_step_launch, plus f_and, f_xor (U, R, C) int8,
// dead (U, R) one byte per neuron (torch.bool's storage: 0 or 1) and
// dth (U, R) int32, each contiguous or null (neutral).
extern "C" int lif_step_faults_launch(
    const void* w, const void* spikes, const void* v, const void* refrac,
    const void* thresh, const void* leak, const void* rp, const void* extra,
    const void* f_and, const void* f_xor, const void* dead, const void* dth,
    void* v_out, void* r_out, void* fired_out, int U, int R, int C,
    void* stream) {
  return launch<true>(w, spikes, v, refrac, thresh, leak, rp, extra, f_and,
                      f_xor, dead, dth, v_out, r_out, fired_out, U, R, C,
                      stream);
}
