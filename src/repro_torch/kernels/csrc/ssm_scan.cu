// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py::ssm_scan
// (body _kernel).  Same function, bit for bit, as
// src/repro_torch/kernels/ssm_scan/ref.py::selective_scan:
//   h_t = da_t * h_{t-1} + dbx_t;   y_t[d] = sum_n h_t[d, n] * c_t[n]
// with da, dbx (B, S, D, N), c (B, S, N), y (B, S, D), all float32.  Two
// extensions over the TPU kernel, both needed by models/ssm.py's chunked
// scan and its decode step: ``h0`` (B, D, N) may be given (null means zeros,
// which is the TPU kernel), and ``h_last`` (B, D, N) is written when not
// null.  Any S >= 1, any D and N <= 64 are taken: decode runs at S = 1, so
// the Pallas S % 64 / D % 128 constraints are gone.
//
// Design.  The TPU kernel walks a (B, D/128, S/64) grid with the sequence
// axis innermost and carries the (128, N) state in VMEM from one grid step
// to the next.  Blocks on a GPU run in no order, so here one thread owns one
// (b, d) row for the whole sequence and keeps its N state values in
// registers; the sequence is a loop inside the thread.  Blocks are 128
// threads over d (the TPU's D_BLOCK), so at each step the block's da and
// dbx rows are one contiguous span of 128 * N floats, read as float4s; the
// N values of c_t are the same for the whole block and come through the
// read-only cache.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), and the sum over n is the
// fixed halving tree of ref.py::pairwise_sum, so h_last and y equal the
// plain version bit for bit.  The state is templated on a power-of-two
// bound kMaxN (8, 16, 32, 64); lanes n..kMaxN-1 hold zeros, which leave the
// tree's sums unchanged.
//
// Bound.  Each launch reads da and dbx once (8 * B*S*D*N bytes) and writes
// y (4 * B*S*D): at the main path's prefill chunk (4, 256, 8192, 16) that
// is 1.11 GB, ~0.33 ms at 3.35 TB/s, against 4 * B*S*D*N flops (~0.54
// GFLOP) that no compute bound comes near.  A decode launch (S = 1) is
// launch-bound.  Expanding da/dbx inside the kernel from (B, S, D) inputs
// would cut the bytes N-fold; that fusion is a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

// Loads ``n`` floats from ``src`` into ``out``, zeros beyond them; float4
// loads when ``vec`` (n % 4 == 0 and every row 16-byte aligned).
template <int kMaxN>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int n,
                                         bool vec, float (&out)[kMaxN]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kMaxN / 4; ++q) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * q < n) v = __ldg(reinterpret_cast<const float4*>(src) + q);
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) out[j] = j < n ? __ldg(src + j) : 0.f;
  }
}

template <int kMaxN>
__global__ void __launch_bounds__(kBlock)
ssm_scan_kernel(const float* __restrict__ da, const float* __restrict__ dbx,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, int S, int D,
                int n, bool vec) {
  const int d = blockIdx.x * kBlock + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = (size_t)b * D + d;  // (b, d) in (B, D)
  float h[kMaxN];
  if (h0 != nullptr) {
    load_row<kMaxN>(h0 + row * n, n, vec, h);
  } else {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) h[j] = 0.f;
  }
  const size_t step = (size_t)D * n;  // da/dbx floats per time step
  const float* da_t = da + ((size_t)b * S * D + d) * n;
  const float* dbx_t = dbx + ((size_t)b * S * D + d) * n;
  const float* c_t = c + (size_t)b * S * n;
  float* y_t = y + (size_t)b * S * D + d;
#pragma unroll 2
  for (int t = 0; t < S; ++t) {
    float a[kMaxN], u[kMaxN], cc[kMaxN], p[kMaxN];
    load_row<kMaxN>(da_t, n, vec, a);
    load_row<kMaxN>(dbx_t, n, vec, u);
    load_row<kMaxN>(c_t, n, vec, cc);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      h[j] = __fadd_rn(__fmul_rn(a[j], h[j]), u[j]);
      p[j] = __fmul_rn(h[j], cc[j]);
    }
#pragma unroll
    for (int w = kMaxN / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) p[j] = __fadd_rn(p[j], p[j + w]);
    }
    *y_t = p[0];
    da_t += step;
    dbx_t += step;
    c_t += n;
    y_t += D;
  }
  if (h_last != nullptr) {
    float* out = h_last + row * n;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) out[j] = h[j];
    }
  }
}

template <int kMaxN>
int launch(const void* da, const void* dbx, const void* c, const void* h0, void* y,
           void* h_last, int B, int S, int D, int n, int vec, void* stream) {
  const dim3 grid((D + kBlock - 1) / kBlock, B);
  ssm_scan_kernel<kMaxN><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)da, (const float*)dbx, (const float*)c, (const float*)h0,
      (float*)y, (float*)h_last, S, D, n, vec != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.
// da, dbx (B, S, D, N), c (B, S, N), y (B, S, D), h0 and h_last (B, D, N),
// all float32 and contiguous; h0 and h_last may be null.  Needs S >= 1,
// D >= 1, 1 <= N <= 64 and 1 <= B <= 65535.  ``vec`` != 0 asks for float4
// loads: the caller promises N % 4 == 0 and 16-byte aligned pointers.
extern "C" int ssm_scan_launch(const void* da, const void* dbx, const void* c,
                               const void* h0, void* y, void* h_last, int B, int S,
                               int D, int N, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > 64)
    return (int)cudaErrorInvalidValue;
  if (N <= 8) return launch<8>(da, dbx, c, h0, y, h_last, B, S, D, N, vec, stream);
  if (N <= 16) return launch<16>(da, dbx, c, h0, y, h_last, B, S, D, N, vec, stream);
  if (N <= 32) return launch<32>(da, dbx, c, h0, y, h_last, B, S, D, N, vec, stream);
  return launch<64>(da, dbx, c, h0, y, h_last, B, S, D, N, vec, stream);
}
