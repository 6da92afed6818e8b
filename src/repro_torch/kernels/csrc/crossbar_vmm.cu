// Quantized crossbar VMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/crossbar_vmm/kernel.py::_kernel (+ _vmm_body), reached
// through crossbar_vmm_tiles.  Same function, bit for bit, as
// src/repro_torch/kernels/crossbar_vmm/ref.py::crossbar_vmm_batch:
//   out[b, r] = clip(sum_c W_b[r, c] * clip(x[b, c], +-2^(in_res-1)),
//                    -2^(out_res+7), 2^(out_res+7) - 1).
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
// Bound.  Bytes: U*R*C weights + U*C*4 in + U*R*4 out = 270,336 B at U=4,
// R=C=256, i.e. 0.081 us at 3.35 TB/s; 2*U*R*C = 0.5 M integer operations
// are far below any compute bound.  A launch costs microseconds, so at the
// VP's shapes the launch dominates, not this body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void crossbar_vmm_kernel(const int8_t* __restrict__ w,
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
  const int8_t* wrow = w + (size_t)b * w_stride + (size_t)row * C;
  unsigned acc = 0;
  if ((C & 3) == 0 && (w_stride & 3) == 0 && ((uintptr_t)w & 3) == 0) {
    // every row starts 4-byte aligned: char4 loads
    const char4* w4 = reinterpret_cast<const char4*>(wrow);
    for (int q = lane; q < (C >> 2); q += 32) {
      const char4 v = w4[q];
      const int c = q << 2;
      acc += (unsigned)((int)v.x * xs[c]) + (unsigned)((int)v.y * xs[c + 1]) +
             (unsigned)((int)v.z * xs[c + 2]) + (unsigned)((int)v.w * xs[c + 3]);
    }
  } else {
    for (int c = lane; c < C; c += 32) acc += (unsigned)((int)wrow[c] * xs[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const int hi_out = (1 << (out_res + 7)) - 1;
  out[(size_t)b * R + row] = min(max((int)acc, -hi_out - 1), hi_out);
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() after the launch (0 on
// success).  Shapes: x (B, C) int32; out (B, R) int32; batch row b reads the
// int8 (R, C) weights at w + b * w_stride bytes.  All contiguous.  Needs
// C * 4 bytes of shared memory, B <= 65535 and 1 <= in_res, out_res <= 15.
extern "C" int crossbar_vmm_launch(const void* w, const void* x, void* out,
                                   int B, int R, int C, long long w_stride,
                                   int in_res, int out_res, void* stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  const dim3 block(32 * kWarpsPerBlock);
  const size_t shmem = (size_t)C * sizeof(int32_t);
  crossbar_vmm_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int32_t*)x, (int32_t*)out, R, C, w_stride,
      in_res, out_res);
  return (int)cudaGetLastError();
}
