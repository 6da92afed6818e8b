// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a), plain C
// interface, in two instantiations of one body.
//
// Unfused (``ssm_scan_launch``): replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan/kernel.py::ssm_scan (body _kernel).  Same
// function, bit for bit, as src/repro_torch/kernels/ssm_scan/ref.py::
// selective_scan:
//   h_t = da_t * h_{t-1} + dbx_t;   y_t[d] = sum_n h_t[d, n] * c_t[n]
// with da, dbx (B, S, D, N), c (B, S, N), y (B, S, D), all float32.  Two
// extensions over the TPU kernel: ``h0`` (B, D, N) may be given (null means
// zeros, which is the TPU kernel), and ``h_last`` (B, D, N) is written when
// not null.  Any S >= 1, any D and N <= 64 are taken.
//
// Fused (``ssm_scan_fused_launch``): the same recurrence with the Mamba-1
// expansion done in registers, so the (B, S, D, N) tiles never exist.  Same
// function, bit for bit, as ref.py::selective_scan_fused:
//   da_t[d, n] = exp(dt_t[d] * A[d, n]);  dbx_t[d, n] = (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] += x_t[d] * d_skip[d]     (when d_skip is given)
// with dt, x (B, S, D), B and C (B, S, N) at any row strides (last stride
// 1), A (D, N).  This is what models/ssm.py runs for a whole prompt in one
// launch and for every decode step.
//
// Design.  The TPU kernel walks a (B, D/128, S/64) grid with the sequence
// axis innermost and carries the (128, N) state in VMEM from one grid step
// to the next.  Blocks on a GPU run in no order, so here one thread owns one
// (b, d) row for the whole sequence and keeps its N state values (and, fused,
// its row of A) in registers; the sequence is a loop inside the thread.
// Blocks are 128 threads over d (the TPU's D_BLOCK).  Unfused, each step's
// da and dbx rows are one contiguous span of 128 * N floats for the block,
// read as float4s, and c_t comes through the read-only cache.  Fused, the
// block stages kTile steps of B and C (the same for every thread) in shared
// memory, each thread loads its kTile values of dt and x (coalesced over d)
// into registers, and then runs the tile's steps from registers and
// broadcast shared loads.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), the exponential is expf (the
// function torch.exp computes on the card), and the sum over n is the fixed
// halving tree of ref.py::pairwise_sum, so h_last and y equal the plain
// versions bit for bit.  The state is templated on a power-of-two bound
// kMaxN (8, 16, 32, 64); lanes n..kMaxN-1 hold zeros, which leave the tree's
// sums unchanged.
//
// Bound.  Unfused, each launch reads da and dbx once (8 * B*S*D*N bytes):
// at a (4, 256, 8192, 16) prefill chunk 1.11 GB, ~0.33 ms at 3.35 TB/s.
// Fused, it reads dt and x (8 * B*S*D bytes), B, C, A and h0 and writes y
// and h_last: at a (4, 512, 8192, 16) prompt 0.21 GB, ~0.06 ms, N times
// fewer bytes; its 7 operations per state element and step (two multiplies
// and an exp for the expansion, two for the recurrence, one product and one
// add for the output) are ~0.03 ms at 67 TFLOP/s.  A decode launch (S = 1)
// is launch-bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 16;  // fused: steps of B and C staged in shared memory

struct Args {
  // unfused inputs
  const float* da;
  const float* dbx;
  // fused inputs; the rows of b (and c) at (b, t) start at b * b_sb + t * b_ss
  const float* dt;
  const float* x;
  const float* bm;
  const float* a;
  const float* d_skip;
  long long b_sb, b_ss, c_sb, c_ss;
  // both
  const float* c;
  const float* h0;
  float* y;
  float* h_last;
  int S, D, n;
  bool vec;
};

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

// One step of the recurrence on a row: h = a * h + u, then the pairwise sum
// of h * c over the kMaxN lanes.
template <int kMaxN>
__device__ __forceinline__ float recur(float (&h)[kMaxN], const float (&a)[kMaxN],
                                       const float (&u)[kMaxN], const float* cc) {
  float p[kMaxN];
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
  return p[0];
}

template <int kMaxN, bool kFused>
__global__ void __launch_bounds__(kBlock) ssm_scan_kernel(const Args g) {
  const int d = blockIdx.x * kBlock + threadIdx.x;
  const int b = blockIdx.y;
  const int S = g.S, D = g.D, n = g.n;
  const bool active = d < D;
  const size_t row = (size_t)b * D + d;  // (b, d) in (B, D)
  float h[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) h[j] = 0.f;
  if (active && g.h0 != nullptr) load_row<kMaxN>(g.h0 + row * n, n, g.vec, h);
  float* y_t = g.y + (size_t)b * S * D + d;

  if constexpr (!kFused) {
    if (!active) return;
    const size_t step = (size_t)D * n;  // da/dbx floats per time step
    const float* da_t = g.da + ((size_t)b * S * D + d) * n;
    const float* dbx_t = g.dbx + ((size_t)b * S * D + d) * n;
    const float* c_t = g.c + (size_t)b * S * n;
#pragma unroll 2
    for (int t = 0; t < S; ++t) {
      float a[kMaxN], u[kMaxN], cc[kMaxN];
      load_row<kMaxN>(da_t, n, g.vec, a);
      load_row<kMaxN>(dbx_t, n, g.vec, u);
      load_row<kMaxN>(c_t, n, g.vec, cc);
      *y_t = recur<kMaxN>(h, a, u, cc);
      da_t += step;
      dbx_t += step;
      c_t += n;
      y_t += D;
    }
  } else {
    __shared__ float b_sh[kTile][kMaxN];
    __shared__ float c_sh[kTile][kMaxN];
    float arow[kMaxN];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) arow[j] = 0.f;
    if (active) load_row<kMaxN>(g.a + (size_t)d * n, n, g.vec, arow);
    const float dsk = active && g.d_skip != nullptr ? g.d_skip[d] : 0.f;
    const float* dt_b = g.dt + (size_t)b * S * D + d;
    const float* x_b = g.x + (size_t)b * S * D + d;
    const float* bm_b = g.bm + b * g.b_sb;
    const float* c_b = g.c + b * g.c_sb;
    for (int t0 = 0; t0 < S; t0 += kTile) {
      // stage the tile's B and C rows; lanes past n and steps past S are 0
      for (int i = threadIdx.x; i < kTile * kMaxN; i += kBlock) {
        const int k = i / kMaxN, j = i % kMaxN;
        const bool in = j < n && t0 + k < S;
        b_sh[k][j] = in ? __ldg(bm_b + (t0 + k) * g.b_ss + j) : 0.f;
        c_sh[k][j] = in ? __ldg(c_b + (t0 + k) * g.c_ss + j) : 0.f;
      }
      float dtr[kTile], xr[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const bool in = active && t0 + k < S;
        dtr[k] = in ? __ldg(dt_b + (size_t)(t0 + k) * D) : 0.f;
        xr[k] = in ? __ldg(x_b + (size_t)(t0 + k) * D) : 0.f;
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (t0 + k < S) {
            const float dtx = __fmul_rn(dtr[k], xr[k]);
            float a[kMaxN], u[kMaxN];
#pragma unroll
            for (int j = 0; j < kMaxN; ++j) {
              a[j] = expf(__fmul_rn(dtr[k], arow[j]));
              u[j] = __fmul_rn(dtx, b_sh[k][j]);
            }
            float yv = recur<kMaxN>(h, a, u, c_sh[k]);
            if (g.d_skip != nullptr) yv = __fadd_rn(yv, __fmul_rn(xr[k], dsk));
            y_t[(size_t)(t0 + k) * D] = yv;
          }
        }
      }
      __syncthreads();
    }
  }
  if (active && g.h_last != nullptr) {
    float* out = g.h_last + row * n;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) out[j] = h[j];
    }
  }
}

template <bool kFused>
int launch(const Args& g, int B, void* stream) {
  const dim3 grid((g.D + kBlock - 1) / kBlock, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.n <= 8) ssm_scan_kernel<8, kFused><<<grid, kBlock, 0, st>>>(g);
  else if (g.n <= 16) ssm_scan_kernel<16, kFused><<<grid, kBlock, 0, st>>>(g);
  else if (g.n <= 32) ssm_scan_kernel<32, kFused><<<grid, kBlock, 0, st>>>(g);
  else ssm_scan_kernel<64, kFused><<<grid, kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int D, int N) {
  return B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > 64;
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
  if (bad_shape(B, S, D, N)) return (int)cudaErrorInvalidValue;
  Args g = {};
  g.da = (const float*)da;
  g.dbx = (const float*)dbx;
  g.c = (const float*)c;
  g.h0 = (const float*)h0;
  g.y = (float*)y;
  g.h_last = (float*)h_last;
  g.S = S;
  g.D = D;
  g.n = N;
  g.vec = vec != 0;
  return launch<false>(g, B, stream);
}

// The fused scan.  dt, x and y (B, S, D), a (D, N), h0 and h_last (B, D, N),
// d_skip (D,), float32 and contiguous; b and c (B, S, N) float32 with the
// strides (b_sb, b_ss, 1) and (c_sb, c_ss, 1) in floats.  h0, h_last and d_skip may be null.
// Shapes as ssm_scan_launch; ``vec`` != 0 promises N % 4 == 0 and 16-byte
// aligned a, h0 and h_last.
extern "C" int ssm_scan_fused_launch(const void* dt, const void* x, const void* b,
                                     const void* c, long long b_sb, long long b_ss,
                                     long long c_sb, long long c_ss,
                                     const void* a, const void* h0, const void* d_skip,
                                     void* y, void* h_last, int B, int S, int D, int N,
                                     int vec, void* stream) {
  if (bad_shape(B, S, D, N)) return (int)cudaErrorInvalidValue;
  Args g = {};
  g.dt = (const float*)dt;
  g.x = (const float*)x;
  g.bm = (const float*)b;
  g.c = (const float*)c;
  g.b_sb = b_sb;
  g.b_ss = b_ss;
  g.c_sb = c_sb;
  g.c_ss = c_ss;
  g.a = (const float*)a;
  g.h0 = (const float*)h0;
  g.d_skip = (const float*)d_skip;
  g.y = (float*)y;
  g.h_last = (float*)h_last;
  g.S = S;
  g.D = D;
  g.n = N;
  g.vec = vec != 0;
  return launch<true>(g, B, stream);
}
