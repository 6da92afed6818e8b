// Quantized crossbar VMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/crossbar_vmm/kernel.py::_kernel and ::_kernel_faults
// (+ _vmm_body), both reached through crossbar_vmm_tiles.  Same function,
// bit for bit, as src/repro_torch/kernels/crossbar_vmm/ref.py::crossbar_vmm_batch:
//   out[b, r] = clip(sum_c W_b[r, c] * clip(x[b, c], +-2^(in_res-1)),
//                    -2^(out_res+7), 2^(out_res+7) - 1),
// where the fault variant (kFaults) reads W_b as (W_b & f_and_b) ^ f_xor_b:
// the crossbar's stuck, flipped and dead cells at read time.  The masks
// share the weights' layout and per-batch-row stride; a null mask is
// neutral.  The fault-free instantiation is the clean kernel unchanged.
// The TPU kernel drives the DAC bit-serially (in_res sign-magnitude bit
// planes, shift-add in fp32 on the MXU).  That decomposition is a model of
// the analog drive and its sum is exact, so it equals the plain integer
// product; here the product accumulates in int32 directly (unsigned
// arithmetic, so any wrap is defined and matches the reference's int32).
//
// Design.  One warp per output row: a row's C int8 weights are contiguous,
// so each lane loads 4 of them as a char4 (bytes one by one when C is not a
// multiple of 4) and the warp's loads are coalesced.  The clipped input
// vector of the block's batch row is staged once in shared memory as int32.
// A __shfl_xor_sync butterfly reduces the warp and lane 0 applies the ADC
// clip.  Ragged R and C are masked.  Each batch row b reads weights at
// w + b * w_stride: the VP's units pass R*C (one crossbar per unit),
// crossbar_matmul passes 0 (one crossbar, N input vectors).  __dp4a and the
// int8 tensor cores (wgmma) are later work.
//
// The fault variant masks each char4 weight load with the masks' char4s
// (& and ^ per byte) before the multiply.
//
// Bound.  Bytes: U*R*C weights + U*C*4 in + U*R*4 out = 270,336 B at U=4,
// R=C=256, i.e. 0.081 us at 3.35 TB/s (the masks add 2*U*R*C: 0.24 us); 2*U*R*C = 0.5 M integer operations
// are far below any compute bound.  A launch costs microseconds, so at the
// VP's shapes the launch dominates, not this body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kFaults>
__global__ void crossbar_vmm_kernel(const int8_t* __restrict__ w,
                                    const int8_t* __restrict__ f_and,
                                    const int8_t* __restrict__ f_xor,
                                    const int32_t* __restrict__ x,
                                    int32_t* __restrict__ out, int R, int C,
                                    long long w_stride, int in_res,
                                    int out_res) {
  extern __shared__ int32_t xs[];  // the clipped input vector (C)
  const int b = blockIdx.y;
  const int lo_in = -(1 << (in_res - 1));
  const int hi_in = (1 << (in_res - 1)) - 1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    xs[c] = min(max(x[(size_t)b * C + c], lo_in), hi_in);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= R) return;  // whole warp leaves together: the shuffles stay full
  const size_t base = (size_t)b * w_stride + (size_t)row * C;
  const int8_t* wrow = w + base;
  const int8_t* arow = kFaults && f_and != nullptr ? f_and + base : nullptr;
  const int8_t* xrow = kFaults && f_xor != nullptr ? f_xor + base : nullptr;
  const bool aligned4 =
      (C & 3) == 0 && (w_stride & 3) == 0 && ((uintptr_t)w & 3) == 0 &&
      (!kFaults || (((uintptr_t)f_and | (uintptr_t)f_xor) & 3) == 0);
  unsigned acc = 0;
  if (aligned4) {
    // every row starts 4-byte aligned: char4 loads
    const char4* w4 = reinterpret_cast<const char4*>(wrow);
    for (int q = lane; q < (C >> 2); q += 32) {
      char4 v = w4[q];
      if constexpr (kFaults) {
        if (arow != nullptr) {
          const char4 a = reinterpret_cast<const char4*>(arow)[q];
          v = make_char4(v.x & a.x, v.y & a.y, v.z & a.z, v.w & a.w);
        }
        if (xrow != nullptr) {
          const char4 f = reinterpret_cast<const char4*>(xrow)[q];
          v = make_char4(v.x ^ f.x, v.y ^ f.y, v.z ^ f.z, v.w ^ f.w);
        }
      }
      const int c = q << 2;
      acc += (unsigned)((int)v.x * xs[c]) + (unsigned)((int)v.y * xs[c + 1]) +
             (unsigned)((int)v.z * xs[c + 2]) + (unsigned)((int)v.w * xs[c + 3]);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      int wc = wrow[c];
      if constexpr (kFaults) {
        if (arow != nullptr) wc &= arow[c];
        if (xrow != nullptr) wc ^= xrow[c];
      }
      acc += (unsigned)(wc * xs[c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const int hi_out = (1 << (out_res + 7)) - 1;
  out[(size_t)b * R + row] = min(max((int)acc, -hi_out - 1), hi_out);
}

template <bool kFaults>
int launch(const void* w, const void* f_and, const void* f_xor, const void* x,
           void* out, int B, int R, int C, long long w_stride, int in_res,
           int out_res, void* stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  const dim3 block(32 * kWarpsPerBlock);
  const size_t shmem = (size_t)C * sizeof(int32_t);
  crossbar_vmm_kernel<kFaults><<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int8_t*)f_and, (const int8_t*)f_xor,
      (const int32_t*)x, (int32_t*)out, R, C, w_stride, in_res, out_res);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() after the launch (0 on
// success).  Shapes: x (B, C) int32; out (B, R) int32; batch row b reads the
// int8 (R, C) weights at w + b * w_stride bytes.  All contiguous.  Needs
// C * 4 bytes of shared memory, B <= 65535 and 1 <= in_res, out_res <= 15.
extern "C" int crossbar_vmm_launch(const void* w, const void* x, void* out,
                                   int B, int R, int C, long long w_stride,
                                   int in_res, int out_res, void* stream) {
  return launch<false>(w, nullptr, nullptr, x, out, B, R, C, w_stride, in_res,
                       out_res, stream);
}

// The fault variant: as crossbar_vmm_launch, plus the int8 masks f_and and
// f_xor laid out like the weights (batch row b at + b * w_stride), each
// contiguous or null (neutral).
extern "C" int crossbar_vmm_faults_launch(const void* w, const void* f_and,
                                          const void* f_xor, const void* x,
                                          void* out, int B, int R, int C,
                                          long long w_stride, int in_res,
                                          int out_res, void* stream) {
  return launch<true>(w, f_and, f_xor, x, out, B, R, C, w_stride, in_res,
                      out_res, stream);
}
