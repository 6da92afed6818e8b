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
// Design.  A (b, d) row's kMaxN state lanes are split over a group of
// kMaxN / 4 threads, four lanes each (4 threads at N = 16), so a thread's
// state, carries and a tile of recomputed states fit in registers; a block
// is 256 threads, 256 / (kMaxN / 4) rows (64 at N = 16).  The walk back
// needs every h_{t-1}.  The block walks one sequence of tiles of kBwdT = 8
// steps:
//   1. pass 1: the recurrence forward over the whole sequence, the state
//      entering every chunk of kBwdC = 32 steps saved in a (B, ceil(S /
//      32), D, kMaxN) scratch (each thread its own float4, read back only
//      by itself);
//   2. the chunks from last to first: a chunk's tiles but its last rerun
//      forward from its saved state, the state entering each tile kept in
//      shared memory (a thread's own float4 per tile); then
//   3. the chunk's tiles from last to first: a tile's states and decays
//      recomputed into registers (h and da for 8 steps: one expf per state
//      element and step, which the reverse walk reuses), then the reverse
//      recurrence back through them, the carry g in registers.
// Each tile's B, C, dt, x and dy are staged into shared memory by
// cp.async, two tiles ahead, in three buffers: a forward tile needs one
// barrier.  The sums over n (for d_dt and d_x) are log2(kMaxN / 4)
// shuffle levels inside the row's group.  The sums over d of d_B and d_C
// start as a reduce-scatter over the warp's rows: each thread holds 8
// products (4 lanes x B|C) and each level halves them between the two
// partners, so after log2(32 / group) levels the warp's threads hold
// distinct (n, B|C) sums (7 shuffles a thread and step at N = 16, not
// 2 x 4 butterflies of 5).  A tile's warp sums go to shared memory and are
// added over the block's warps in a fixed order into (B, S, ceil(D / rows),
// N) partials that the wrapper sums with one torch call; d_A accumulates
// over t in registers and is written per b, (B, D, N), for a torch sum over
// B.  No float atomics: the same inputs give the same bits.  Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn) and da is expf, so
// the recomputed states equal the forward's; the sums over n and d are
// taken in another order than the plain version's.
//
// Bound.  It reads dt, x and dy (12 * B*S*D bytes), B and C, A, h0 and
// dh_last, and writes d_dt, d_x (8 * B*S*D), the partials and d_A, d_h0:
// at (4, 1024, 8192, 16) ~0.67 GB, ~0.20 ms at 3.35 TB/s.  The scratch
// adds 4 * B*S*D*kMaxN / 32 bytes each way (67 MB there), the partials
// 8 * B*S*N * D / 64 (67 MB), read once more by the wrapper's sums.  The
// work is float32 elementwise arithmetic and sums, no matrix product, so
// tensor cores do not apply.  Per state element and step it issues ~62
// instructions: the forward recurrence in pass 1, over 3/4 of the steps
// again in the rerun and in the tile's recompute (~13 each: an expf of 8
// with one MUFU, 4 more, the staged loads), the reverse one (~13) and the
// sums (~12 with shuffles and selects): ~1.0 ms at the card's 128 lanes
// a cycle per SM (1.98 GHz), the MUFU's 16 a cycle ~0.35 ms.  It runs at
// ~2.0 ms (H100 80GB HBM3, 700 W): at 125 registers two blocks of 8 warps
// fit an SM, too few to hide the latency of the expf, shuffle and shared
// load chains (__expf, 27% fewer instructions, took 7% off; a state saved
// every 8 steps, with no rerun, took 16% off for 4x the scratch bytes).
constexpr int kBwdBlock = 256;  // threads of a backward block
constexpr int kBwdE = 4;        // state lanes a thread carries
constexpr int kBwdT = 8;        // steps of a register tile
constexpr int kBwdC = 32;       // steps between saved states (a multiple of kBwdT)

template <int kMaxN>
struct BwdLayout {
  static constexpr int kG = kMaxN / kBwdE;       // threads of a row's group
  static constexpr int kRows = kBwdBlock / kG;   // rows of a block
  static constexpr int kWarps = kBwdBlock / 32;
  static constexpr int kSub = kBwdC / kBwdT;     // tiles of a chunk
  struct Stage {  // one tile's inputs, staged by cp.async
    float4 h_saved[kBwdBlock];  // a chunk's saved state, for the chunk's tiles 0
    float bm[kBwdT][kMaxN];
    float c[kBwdT][kMaxN];
    float dt[kBwdT][kRows];
    float x[kBwdT][kRows];
    float dy[kBwdT][kRows];
  };
  struct Smem {
    Stage st[3];                           // this tile's and the next two's
    float4 h_in[kSub][kBwdBlock];          // the state entering each tile of the chunk
    float red[kBwdT][kWarps][2 * kMaxN];   // each warp's d_B | d_C sums per step
  };
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
  float4* states;
  float* d_dt;
  float* d_x;
  float* d_b;
  float* d_c;
  float* d_a;
  float* d_h0;
  int S, D, n;
  bool vec;
};

// Asynchronous copies into shared memory: 4 bytes (zeros where ``in`` is
// false; the source is then not read), or 16 bytes past L1.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Loads lanes n0..n0+3 of a row of ``n`` floats, zeros past n; one float4
// when ``vec`` (n % 4 == 0 and the row 16-byte aligned).
__device__ __forceinline__ void load4(const float* __restrict__ row, int n0, int n,
                                      bool vec, float (&out)[kBwdE]) {
  if (vec) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 < n) v = __ldg(reinterpret_cast<const float4*>(row + n0));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kBwdE; ++j) out[j] = n0 + j < n ? __ldg(row + n0 + j) : 0.f;
  }
}

__device__ __forceinline__ void to4(const float4 v, float (&out)[kBwdE]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ float4 from4(const float (&v)[kBwdE]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The reduce-scatter of a step's 8 products (v[0..3] g * dt * x for the
// thread's lanes, v[4..7] h * dy) over the warp's rows, at lane offsets
// kO, kO / 2, ..., kG: at each level the partner with the offset's bit set
// keeps the upper half of the live values and receives the other's, the
// other the lower half; once one value is left, the level adds both
// partners' (both then hold the sum, and ``writer`` keeps one).  ``base``
// ends as the index in 0..7 of the thread's first value.
template <int kO, int kM, int kG>
__device__ __forceinline__ void rows_sum(float (&v)[2 * kBwdE], int lane, int& base,
                                         bool& writer) {
  if constexpr (kO >= kG) {
    const bool up = (lane & kO) != 0;
    if constexpr (kM > 1) {
      constexpr int kH = kM / 2;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float send = up ? v[i] : v[kH + i];
        const float keep = up ? v[kH + i] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, kO));
      }
      if (up) base += kH;
      rows_sum<kO / 2, kH, kG>(v, lane, base, writer);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], kO));
      writer = writer && !up;
      rows_sum<kO / 2, 1, kG>(v, lane, base, writer);
    }
  }
}

// The block's walk is one sequence of tiles of kBwdT steps: pass 1's
// tiles 0..n_tiles-1 forward; then the chunks from last to first, each
// one's tiles 0..n_sub-2 forward again (the rerun) and its tiles
// n_sub-1..0 back.  ``ci`` is -1 in pass 1; ``s`` the tile in its chunk.
struct BwdTile {
  int t0, ci, s;
  bool back;
};

__device__ __forceinline__ int bwd_tiles(int S) {
  const int n_tiles = (S + kBwdT - 1) / kBwdT, n_chunks = (S + kBwdC - 1) / kBwdC;
  const int last_sub = n_tiles - (n_chunks - 1) * (kBwdC / kBwdT);
  return n_tiles + 2 * last_sub - 1 + (n_chunks - 1) * (2 * (kBwdC / kBwdT) - 1);
}

__device__ __forceinline__ BwdTile bwd_tile_at(int i, int S) {
  constexpr int kSub = kBwdC / kBwdT;
  const int n_tiles = (S + kBwdT - 1) / kBwdT, n_chunks = (S + kBwdC - 1) / kBwdC;
  if (i < n_tiles) return {i * kBwdT, -1, i % kSub, false};
  int j = i - n_tiles, ci = n_chunks - 1, n_sub = n_tiles - ci * kSub;
  if (j >= 2 * n_sub - 1) {
    j -= 2 * n_sub - 1;
    ci = n_chunks - 2 - j / (2 * kSub - 1);
    j %= 2 * kSub - 1;
    n_sub = kSub;
  }
  if (j < n_sub - 1) return {ci * kBwdC + j * kBwdT, ci, j, false};
  const int s = 2 * n_sub - 2 - j;
  return {ci * kBwdC + s * kBwdT, ci, s, true};
}

template <int kMaxN>
__global__ void __launch_bounds__(kBwdBlock, 2) ssm_scan_bwd_kernel(const BwdArgs g) {
  using L = BwdLayout<kMaxN>;
  constexpr int kG = L::kG, kRows = L::kRows, kT = kBwdT;
  constexpr int kLeft = 2 * kBwdE * kG / 32 > 1 ? 2 * kBwdE * kG / 32 : 1;  // sums a thread keeps
  extern __shared__ float4 smem_raw[];
  typename L::Smem& sm = *reinterpret_cast<typename L::Smem*>(smem_raw);
  const int tid = threadIdx.x, q = tid % kG, r = tid / kG;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * kRows + r;
  const int b = blockIdx.y;
  const int S = g.S, D = g.D, n = g.n, n0 = kBwdE * q;
  const int n_chunks = (S + kBwdC - 1) / kBwdC;
  const bool active = d < D;
  const size_t row = (size_t)b * D + d;
  float arow[kBwdE], h[kBwdE], gc[kBwdE], da_acc[kBwdE];  // gc: g's carry da_{t+1} * g_{t+1}
#pragma unroll
  for (int j = 0; j < kBwdE; ++j) arow[j] = h[j] = gc[j] = da_acc[j] = 0.f;
  if (active) load4(g.a + (size_t)d * n, n0, n, g.vec, arow);
  if (active && g.h0 != nullptr) load4(g.h0 + row * n, n0, n, g.vec, h);
  if (active && g.dh_last != nullptr) load4(g.dh_last + row * n, n0, n, g.vec, gc);
  const float dsk = active && g.d_skip != nullptr ? g.d_skip[d] : 0.f;
  const float* bm_b = g.bm + b * g.b_sb;
  const float* c_b = g.c + b * g.c_sb;
  // the state entering chunk i of this thread's lanes: (B, n_chunks, D, kMaxN)
  float4* const saved = g.states + ((size_t)b * n_chunks * D + (active ? d : 0)) * kG + q;
  const size_t chunk_stride = (size_t)D * kG;
  if (active) *saved = from4(h);

  // stages a tile's B and dt, x (and C, dy going back) into st: steps past
  // S and lanes past n are zeros; a chunk's tile 0 also takes its saved
  // state, but for the last chunk's: pass 1 may write that one after the
  // copy is issued (when the chunk is one tile), so it is read in place
  auto issue = [&](const BwdTile tl, typename L::Stage& st) {
    for (int i = tid; i < kT * kMaxN; i += kBwdBlock) {
      const int k = i / kMaxN, j = i % kMaxN;
      const bool in = j < n && tl.t0 + k < S;
      cp_async4(&st.bm[k][j], in ? bm_b + (tl.t0 + k) * g.b_ss + j : bm_b, in);
      if (tl.back) cp_async4(&st.c[k][j], in ? c_b + (tl.t0 + k) * g.c_ss + j : c_b, in);
    }
    for (int i = tid; i < kT * kRows; i += kBwdBlock) {
      const int k = i / kRows, rr = i % kRows, dd = blockIdx.x * kRows + rr;
      const bool in = dd < D && tl.t0 + k < S;
      const size_t o = in ? ((size_t)b * S + tl.t0 + k) * D + dd : 0;
      cp_async4(&st.dt[k][rr], g.dt + o, in);
      cp_async4(&st.x[k][rr], g.x + o, in);
      if (tl.back) cp_async4(&st.dy[k][rr], g.dy + o, in);
    }
    if (tl.ci >= 0 && tl.ci < n_chunks - 1 && tl.s == 0)
      cp_async16(&st.h_saved[tid], saved + tl.ci * chunk_stride, active);
    cp_async_commit();
  };

  // tile i's inputs arrive in st[i % 3] while tiles i - 1 and i - 2 run:
  // it is issued past the barrier that ends every thread's use of tile
  // i - 3's, so a forward tile needs one barrier
  const int n_walk = bwd_tiles(S);
  issue(bwd_tile_at(0, S), sm.st[0]);
  if (n_walk > 1) issue(bwd_tile_at(1, S), sm.st[1]);
  for (int i = 0; i < n_walk; ++i) {
    const BwdTile tl = bwd_tile_at(i, S);
    const typename L::Stage& st = sm.st[i % 3];
    if (i + 1 < n_walk) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    if (i + 2 < n_walk) issue(bwd_tile_at(i + 2, S), sm.st[(i + 2) % 3]);
    const int t0 = tl.t0;
    // the state entering the chunk, for the chunk's tile 0
    auto chunk_state = [&]() {
      if (tl.ci < n_chunks - 1) return st.h_saved[tid];
      return active ? saved[tl.ci * chunk_stride] : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    if (!tl.back) {
      // h steps forward over the tile (steps past S leave it as it is)
      if (tl.ci >= 0 && tl.s == 0) to4(chunk_state(), h);
#pragma unroll
      for (int k = 0; k < kT; ++k) {
        const float dtv = st.dt[k][r];
        const float dtx = __fmul_rn(dtv, st.x[k][r]);
        float bq[kBwdE];
        to4(*reinterpret_cast<const float4*>(&st.bm[k][n0]), bq);
#pragma unroll
        for (int j = 0; j < kBwdE; ++j) {
          const float da = expf(__fmul_rn(dtv, arow[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, bq[j]));
        }
      }
      if (tl.ci >= 0) sm.h_in[tl.s + 1][tid] = from4(h);  // read back only by this thread
      else if ((t0 + kT) % kBwdC == 0 && t0 + kT < S && active)
        saved[(t0 + kT) / kBwdC * chunk_stride] = from4(h);
      continue;
    }
    // back: the tile's states and decays recomputed into registers ...
    float hs[kT + 1][kBwdE], dav[kT][kBwdE];  // hs[k] = h_{t0+k-1}; dav[k] = da_{t0+k}
    to4(tl.s == 0 ? chunk_state() : sm.h_in[tl.s][tid], hs[0]);
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const float dtv = st.dt[k][r];
      const float dtx = __fmul_rn(dtv, st.x[k][r]);
      float bq[kBwdE];
      to4(*reinterpret_cast<const float4*>(&st.bm[k][n0]), bq);
#pragma unroll
      for (int j = 0; j < kBwdE; ++j) {
        dav[k][j] = expf(__fmul_rn(dtv, arow[j]));
        hs[k + 1][j] = __fadd_rn(__fmul_rn(dav[k][j], hs[k][j]), __fmul_rn(dtx, bq[j]));
      }
    }
    // ... and the reverse recurrence back through them.  A step past S
    // has zeros staged (da = 1, g unchanged, zero products) and stores
    // nothing, so the tile is one block of straight-line code that the
    // compiler can interleave across steps
#pragma unroll
    for (int k = kT - 1; k >= 0; --k) {
      const bool in = t0 + k < S;
      const float dtv = st.dt[k][r], xv = st.x[k][r], dyv = st.dy[k][r];
      const float dtx = __fmul_rn(dtv, xv);
      float bq[kBwdE], cq[kBwdE], v[2 * kBwdE];
      to4(*reinterpret_cast<const float4*>(&st.bm[k][n0]), bq);
      to4(*reinterpret_cast<const float4*>(&st.c[k][n0]), cq);
      float s_dt = 0.f, s_gb = 0.f;
#pragma unroll
      for (int j = 0; j < kBwdE; ++j) {
        const float gt = __fadd_rn(gc[j], __fmul_rn(dyv, cq[j]));
        const float e = __fmul_rn(__fmul_rn(gt, hs[k][j]), dav[k][j]);
        da_acc[j] = __fadd_rn(da_acc[j], __fmul_rn(e, dtv));
        s_dt = __fadd_rn(s_dt, __fmul_rn(e, arow[j]));
        s_gb = __fadd_rn(s_gb, __fmul_rn(gt, bq[j]));
        gc[j] = __fmul_rn(dav[k][j], gt);
        v[j] = __fmul_rn(gt, dtx);
        v[kBwdE + j] = __fmul_rn(hs[k + 1][j], dyv);
      }
      // the sums over n: the row's group of threads
#pragma unroll
      for (int o = 1; o < kG; o <<= 1) {
        s_dt = __fadd_rn(s_dt, __shfl_xor_sync(0xffffffffu, s_dt, o));
        s_gb = __fadd_rn(s_gb, __shfl_xor_sync(0xffffffffu, s_gb, o));
      }
      if (in && active && q == 0) {
        const size_t o = ((size_t)b * S + t0 + k) * D + d;
        g.d_dt[o] = __fadd_rn(s_dt, __fmul_rn(s_gb, xv));
        g.d_x[o] = __fadd_rn(__fmul_rn(s_gb, dtv), __fmul_rn(dyv, dsk));
      }
      // the sums over the warp's rows
      int base = 0;
      bool writer = true;
      rows_sum<16, 2 * kBwdE, kG>(v, lane, base, writer);
      if (writer) {
#pragma unroll
        for (int m = 0; m < kLeft; ++m) {
          const int u = base + m;
          sm.red[k][warp][(u < kBwdE ? 0 : kMaxN) + n0 + (u & (kBwdE - 1))] = v[m];
        }
      }
    }
    __syncthreads();
    // the tile's d_B and d_C partials over the block's rows: (B, S, nblk, N);
    // the next walk writes red only past the next tile's barrier
    for (int k2 = tid; k2 < kT * 2 * kMaxN; k2 += kBwdBlock) {
      const int k = k2 / (2 * kMaxN), col = k2 % (2 * kMaxN), j = col % kMaxN;
      if (j < n && t0 + k < S) {
        float sum = sm.red[k][0][col];
#pragma unroll
        for (int w = 1; w < L::kWarps; ++w) sum = __fadd_rn(sum, sm.red[k][w][col]);
        const size_t o = (((size_t)b * S + t0 + k) * gridDim.x + blockIdx.x) * n + j;
        (col < kMaxN ? g.d_b : g.d_c)[o] = sum;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kBwdE; ++j) {
      if (n0 + j < n) {
        g.d_a[row * n + n0 + j] = da_acc[j];
        if (g.d_h0 != nullptr) g.d_h0[row * n + n0 + j] = gc[j];
      }
    }
  }
}

template <int kMaxN>
int bwd_launch(const BwdArgs& g, int B, cudaStream_t st) {
  constexpr int bytes = sizeof(typename BwdLayout<kMaxN>::Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<kMaxN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.D + BwdLayout<kMaxN>::kRows - 1) / BwdLayout<kMaxN>::kRows, B);
  ssm_scan_bwd_kernel<kMaxN><<<grid, kBwdBlock, bytes, st>>>(g);
  return (int)cudaGetLastError();
}

template <int kMaxN>
void bwd_layout(int* out) {
  out[0] = kBwdC;
  out[1] = BwdLayout<kMaxN>::kRows;
  out[2] = kMaxN;
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

// The backward's buffers for N state lanes: out[0] the steps between saved
// states, out[1] the rows of D a block covers, out[2] the lanes a row's
// saved state is padded to.  The caller allocates the scratch as
// (B, ceil(S / out[0]), D, out[2]) and the d_b, d_c partials as
// (B, S, ceil(D / out[1]), N).  Returns 0, or cudaErrorInvalidValue.
extern "C" int ssm_scan_bwd_layout(int N, int* out) {
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  if (N <= 8) bwd_layout<8>(out);
  else if (N <= 16) bwd_layout<16>(out);
  else if (N <= 32) bwd_layout<32>(out);
  else bwd_layout<64>(out);
  return 0;
}

// The fused scan's backward.  Inputs as ssm_scan_fused_launch (h0 and
// d_skip may be null), dy (B, S, D) and dh_last (B, D, N) or null (zero),
// float32 and contiguous.  Writes d_dt and d_x (B, S, D); the partials
// d_b and d_c (B, S, ceil(D / rows), N), each block's sum over its rows;
// d_a (B, D, N), each batch row's sum over t; d_h0 (B, D, N) unless null;
// ``states`` is scratch, 16-byte aligned (sizes: ssm_scan_bwd_layout).
// Shapes as ssm_scan_launch; ``vec`` != 0 promises N % 4 == 0 and 16-byte
// aligned a, h0 and dh_last.
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
  g.states = (float4*)states;
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8) return bwd_launch<8>(g, B, st);
  if (N <= 16) return bwd_launch<16>(g, B, st);
  if (N <= 32) return bwd_launch<32>(g, B, st);
  return bwd_launch<64>(g, B, st);
}
