// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a), plain C
// interface, in two instantiations of one body, and the fused scan's
// backward (``ssm_scan_fused_bwd_launch``, at the end of this file).
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

// ---------------------------------------------------------------------------
// The fused scan's backward.  Replaces no TPU kernel: the JAX package
// differentiates its lax.associative_scan (src/repro/models/ssm.py:60-118),
// and its Pallas ssm_scan has no VJP.  It is the gradient of
// ssm_scan_fused_launch's function (same inputs, y and h_last's gradients
// dy and dh_last), computed as src/repro_torch/kernels/ssm_scan/ref.py::
// selective_scan_fused_bwd writes it out:
//   g_t = C_t * dy_t + da_{t+1} * g_{t+1}   (the carry past the end: dh_last)
//   e_t = g_t * h_{t-1} * da_t              (the gradient of dt_t * A)
//   d_dt_t = sum_n e_t * A + (sum_n g_t * B_t) * x_t
//   d_x_t  = (sum_n g_t * B_t) * dt_t + dy_t * d_skip
//   d_A = sum_{b,t} e_t * dt_t,  d_B_t = sum_d g_t * dt_t * x_t,
//   d_C_t = sum_d h_t * dy_t,    d_h0 = da_0 * g_0.
//
// Design.  The forward's layout: one thread owns one (b, d) row, a block is
// 128 rows, A's row and the running state live in registers.  The walk
// back needs h_{t-1} at every step, so the thread first runs the recurrence
// forward over the whole sequence and stores the state entering every
// tile of kBwdTile steps in a (B, ceil(S / kBwdTile), D, N) scratch (its
// own rows only: read back by the same thread, with plain loads).  It then
// walks the tiles from last to first: it reloads a tile's entering state,
// recomputes the tile's states into registers (kBwdTile * kMaxN <= 128
// floats), and runs the reverse recurrence back through them, the carry g
// in registers.  d_dt and d_x are per row and step.  d_B and d_C are sums
// over d: each step's values are summed over a warp by shuffles and over
// the block's four warps in shared memory, in a fixed order, and written as
// (B, S, ceil(D / 128), N) partials that the wrapper sums with one torch
// call; d_A accumulates over t in registers and is written per b, (B, D, N),
// for a torch sum over B.  No float atomics: the result is deterministic.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn) and
// da is expf, so the recomputed states equal the forward's; the sums over
// n and d are taken in another order than the plain version's.
//
// Bound.  It reads dt, x and dy (12 * B*S*D bytes), B and C, A, h0 and
// dh_last, and writes d_dt, d_x (8 * B*S*D), the partials and d_A, d_h0;
// the scratch is written and read once more (8 * B*S*D*N / kBwdTile).  At
// (4, 1024, 8192, 16) that is ~1.1 GB, ~0.33 ms at 3.35 TB/s.  It runs the
// forward recurrence twice (4 operations per state element and step, plus
// the expansion's 3) and the reverse one once (~14), ~25 operations per
// state element and step: ~0.2 ms at 67 TFLOP/s.  Its parallelism is
// B * D threads, each sequential over S.
template <int kMaxN>
struct BwdTile {
  static constexpr int value = 128 / kMaxN > 16 ? 16 : (128 / kMaxN < 2 ? 2 : 128 / kMaxN);
};

struct BwdArgs {
  const float* dt;
  const float* x;
  const float* bm;
  const float* c;
  const float* a;
  const float* h0;
  const float* d_skip;
  const float* dy;
  const float* dh_last;
  long long b_sb, b_ss, c_sb, c_ss;
  float* states;
  float* d_dt;
  float* d_x;
  float* d_b;
  float* d_c;
  float* d_a;
  float* d_h0;
  int S, D, n;
  bool vec;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int kMaxN>
__global__ void __launch_bounds__(kBlock) ssm_scan_bwd_kernel(const BwdArgs g) {
  constexpr int kT = BwdTile<kMaxN>::value;
  constexpr int kWarps = kBlock / 32;
  __shared__ float b_sh[kT][kMaxN];
  __shared__ float c_sh[kT][kMaxN];
  __shared__ float red_b[kT][kWarps][kMaxN];
  __shared__ float red_c[kT][kWarps][kMaxN];
  const int d = blockIdx.x * kBlock + threadIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = g.S, D = g.D, n = g.n;
  const int n_tiles = (S + kT - 1) / kT;
  const bool active = d < D;
  const size_t row = (size_t)b * D + d;
  float arow[kMaxN], h[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) arow[j] = h[j] = 0.f;
  if (active) load_row<kMaxN>(g.a + (size_t)d * n, n, g.vec, arow);
  if (active && g.h0 != nullptr) load_row<kMaxN>(g.h0 + row * n, n, g.vec, h);
  const float dsk = active && g.d_skip != nullptr ? g.d_skip[d] : 0.f;
  const size_t base = (size_t)b * S * D + d;  // (b, 0, d) in (B, S, D)
  const float* bm_b = g.bm + b * g.b_sb;
  const float* c_b = g.c + b * g.c_sb;
  // the state entering tile i of row (b, d): (B, n_tiles, D, N)
  auto state_row = [&](int i) { return g.states + (((size_t)b * n_tiles + i) * D + d) * n; };

  // pass 1: the recurrence forward, the state entering each tile saved
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = i * kT;
    for (int q = threadIdx.x; q < kT * kMaxN; q += kBlock) {
      const int k = q / kMaxN, j = q % kMaxN;
      b_sh[k][j] = j < n && t0 + k < S ? __ldg(bm_b + (t0 + k) * g.b_ss + j) : 0.f;
    }
    float dtr[kT], xr[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const bool in = active && t0 + k < S;
      dtr[k] = in ? __ldg(g.dt + base + (size_t)(t0 + k) * D) : 0.f;
      xr[k] = in ? __ldg(g.x + base + (size_t)(t0 + k) * D) : 0.f;
    }
    if (active) {
      float* out = state_row(i);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < n) out[j] = h[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      if (t0 + k < S) {
        const float dtx = __fmul_rn(dtr[k], xr[k]);
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          const float da = expf(__fmul_rn(dtr[k], arow[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, b_sh[k][j]));
        }
      }
    }
    __syncthreads();
  }

  // pass 2: the tiles from last to first, the reverse recurrence
  float gc[kMaxN], da_acc[kMaxN];  // g's carry (da_{t+1} * g_{t+1}); d_A's sum
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) gc[j] = da_acc[j] = 0.f;
  if (active && g.dh_last != nullptr) load_row<kMaxN>(g.dh_last + row * n, n, g.vec, gc);
  for (int i = n_tiles - 1; i >= 0; --i) {
    const int t0 = i * kT;
    for (int q = threadIdx.x; q < kT * kMaxN; q += kBlock) {
      const int k = q / kMaxN, j = q % kMaxN;
      const bool in = j < n && t0 + k < S;
      b_sh[k][j] = in ? __ldg(bm_b + (t0 + k) * g.b_ss + j) : 0.f;
      c_sh[k][j] = in ? __ldg(c_b + (t0 + k) * g.c_ss + j) : 0.f;
    }
    float dtr[kT], xr[kT], dyr[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const bool in = active && t0 + k < S;
      dtr[k] = in ? __ldg(g.dt + base + (size_t)(t0 + k) * D) : 0.f;
      xr[k] = in ? __ldg(g.x + base + (size_t)(t0 + k) * D) : 0.f;
      dyr[k] = in ? __ldg(g.dy + base + (size_t)(t0 + k) * D) : 0.f;
    }
    float hp[kT][kMaxN];  // hp[k] = h_{t0+k-1}, the state entering step t0+k
    if (active) {
      const float* src = state_row(i);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) hp[0][j] = j < n ? src[j] : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) hp[0][j] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 1; k < kT; ++k) {
      const float dtx = __fmul_rn(dtr[k - 1], xr[k - 1]);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        const float da = expf(__fmul_rn(dtr[k - 1], arow[j]));
        hp[k][j] = __fadd_rn(__fmul_rn(da, hp[k - 1][j]), __fmul_rn(dtx, b_sh[k - 1][j]));
      }
    }
#pragma unroll
    for (int k = kT - 1; k >= 0; --k) {
      if (t0 + k < S) {  // the same for every thread of the block: shuffles are safe
        const float dtv = dtr[k], xv = xr[k], dyv = dyr[k];
        const float dtx = __fmul_rn(dtv, xv);
        float s_dt = 0.f, s_gb = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          const float da = expf(__fmul_rn(dtv, arow[j]));
          const float ht = __fadd_rn(__fmul_rn(da, hp[k][j]), __fmul_rn(dtx, b_sh[k][j]));
          const float gt = __fadd_rn(gc[j], __fmul_rn(dyv, c_sh[k][j]));
          const float e = __fmul_rn(__fmul_rn(gt, hp[k][j]), da);
          da_acc[j] = __fadd_rn(da_acc[j], __fmul_rn(e, dtv));
          s_dt = __fadd_rn(s_dt, __fmul_rn(e, arow[j]));
          s_gb = __fadd_rn(s_gb, __fmul_rn(gt, b_sh[k][j]));
          gc[j] = __fmul_rn(da, gt);
          const float sb = warp_sum(__fmul_rn(gt, dtx));
          const float sc = warp_sum(__fmul_rn(ht, dyv));
          if (lane == 0) {
            red_b[k][warp][j] = sb;
            red_c[k][warp][j] = sc;
          }
        }
        if (active) {
          const size_t o = base + (size_t)(t0 + k) * D;
          g.d_dt[o] = __fadd_rn(s_dt, __fmul_rn(s_gb, xv));
          g.d_x[o] = __fadd_rn(__fmul_rn(s_gb, dtv), __fmul_rn(dyv, dsk));
        }
      }
    }
    __syncthreads();
    // the tile's d_B and d_C partials over this block's rows: (B, S, nblk, N)
    for (int q = threadIdx.x; q < kT * kMaxN; q += kBlock) {
      const int k = q / kMaxN, j = q % kMaxN;
      if (j < n && t0 + k < S) {
        float sb = red_b[k][0][j], sc = red_c[k][0][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sb = __fadd_rn(sb, red_b[k][w][j]);
          sc = __fadd_rn(sc, red_c[k][w][j]);
        }
        const size_t o = (((size_t)b * S + t0 + k) * gridDim.x + blockIdx.x) * n + j;
        g.d_b[o] = sb;
        g.d_c[o] = sc;
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        g.d_a[row * n + j] = da_acc[j];
        if (g.d_h0 != nullptr) g.d_h0[row * n + j] = gc[j];
      }
    }
  }
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

// Steps between the saved states of ssm_scan_fused_bwd_launch for N state
// lanes: the (B, ceil(S / tile), D, N) scratch the caller allocates.
extern "C" int ssm_scan_bwd_tile(int N) {
  return N <= 8 ? BwdTile<8>::value : N <= 16 ? BwdTile<16>::value
         : N <= 32 ? BwdTile<32>::value : BwdTile<64>::value;
}

// The fused scan's backward.  Inputs as ssm_scan_fused_launch (h0 and
// d_skip may be null), dy (B, S, D) and dh_last (B, D, N) or null (zero),
// float32 and contiguous.  Writes d_dt and d_x (B, S, D); the partials
// d_b and d_c (B, S, ceil(D / 128), N), each block's sum over its rows;
// d_a (B, D, N), each batch row's sum over t; d_h0 (B, D, N) unless null;
// ``states`` is (B, ceil(S / ssm_scan_bwd_tile(N)), D, N) scratch.  Shapes
// as ssm_scan_launch; ``vec`` != 0 promises N % 4 == 0 and 16-byte aligned
// a, h0 and dh_last.
extern "C" int ssm_scan_fused_bwd_launch(
    const void* dt, const void* x, const void* b, const void* c, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, const void* a, const void* h0,
    const void* d_skip, const void* dy, const void* dh_last, void* states, void* d_dt,
    void* d_x, void* d_b, void* d_c, void* d_a, void* d_h0, int B, int S, int D, int N,
    int vec, void* stream) {
  if (bad_shape(B, S, D, N)) return (int)cudaErrorInvalidValue;
  BwdArgs g = {};
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
  g.dy = (const float*)dy;
  g.dh_last = (const float*)dh_last;
  g.states = (float*)states;
  g.d_dt = (float*)d_dt;
  g.d_x = (float*)d_x;
  g.d_b = (float*)d_b;
  g.d_c = (float*)d_c;
  g.d_a = (float*)d_a;
  g.d_h0 = (float*)d_h0;
  g.S = S;
  g.D = D;
  g.n = N;
  g.vec = vec != 0;
  const dim3 grid((D + kBlock - 1) / kBlock, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8) ssm_scan_bwd_kernel<8><<<grid, kBlock, 0, st>>>(g);
  else if (N <= 16) ssm_scan_bwd_kernel<16><<<grid, kBlock, 0, st>>>(g);
  else if (N <= 32) ssm_scan_bwd_kernel<32><<<grid, kBlock, 0, st>>>(g);
  else ssm_scan_bwd_kernel<64><<<grid, kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}
