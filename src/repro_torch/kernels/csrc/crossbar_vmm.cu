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
//
// The fused completion (finish_ops_kernel, finish_ops_launch and its
// kFaults variant finish_ops_faults_launch) is the quantum-boundary step of
// vp/cim.finish_ops in one launch, the same function bit for bit as
// src/repro_torch/kernels/crossbar_vmm/ref.py::finish_ops: per unit
// done = present && state == OP && busy_until <= t_end; a done unit runs
// the VMM above at 8/8 bits into out_buf and returns to IDLE (op_done_at =
// busy_until, ops += 1, in_count = 0); a unit that is not done reads no
// weights and copies out_buf and its FSM fields through.  Every output is a
// new array.  It replaces the ~10 eager ops that surrounded the VMM.  Its
// bound counts the FSM fields once, the weights (and masks) and inputs of
// the done units only and the old outputs of the others: 0.08 us at 4 done
// units of 256x256.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kXbar = 256;  // the largest C of the fused completion

// The VMM's stages, shared by the unfused kernel and the fused completion.

// The DAC: an input clipped to in_res bits.
__device__ __forceinline__ int dac(int x, int in_res) {
  return min(max(x, -(1 << (in_res - 1))), (1 << (in_res - 1)) - 1);
}

// Char4 q of the row at ``base`` of ``p`` (weights or a mask); ``fill`` in
// every byte where ``in`` is false or ``p`` is null (a neutral mask).  The
// load is predicated, not branched around.
__device__ __forceinline__ char4 load4(const int8_t* __restrict__ p, size_t base, int q,
                                       bool in, int fill) {
  return in && p != nullptr ? reinterpret_cast<const char4*>(p + base)[q]
                            : make_char4(fill, fill, fill, fill);
}

// The crossbar's read through the fault masks: (w & f_and) ^ f_xor per byte.
__device__ __forceinline__ char4 mask4(char4 w, char4 a, char4 x) {
  return make_char4((w.x & a.x) ^ x.x, (w.y & a.y) ^ x.y, (w.z & a.z) ^ x.z, (w.w & a.w) ^ x.w);
}

// Four weights times the staged inputs at columns c..c+3, summed (wrapping).
__device__ __forceinline__ unsigned dot4(char4 v, const int32_t* xs, int c) {
  return (unsigned)((int)v.x * xs[c]) + (unsigned)((int)v.y * xs[c + 1]) +
         (unsigned)((int)v.z * xs[c + 2]) + (unsigned)((int)v.w * xs[c + 3]);
}

// A lane's share of a row's contraction byte by byte (C % 4 != 0 or a
// misaligned base), the weights read through the masks as mask4 reads them.
template <bool kFaults>
__device__ __forceinline__ unsigned dot_bytes(const int8_t* __restrict__ w,
                                              const int8_t* __restrict__ f_and,
                                              const int8_t* __restrict__ f_xor, size_t base,
                                              const int32_t* xs, int C, int lane) {
  unsigned acc = 0;
  for (int c = lane; c < C; c += 32) {
    int wc = w[base + c];
    if constexpr (kFaults) {
      if (f_and != nullptr) wc &= f_and[base + c];
      if (f_xor != nullptr) wc ^= f_xor[base + c];
    }
    acc += (unsigned)(wc * xs[c]);
  }
  return acc;
}

// The ADC: the warp's sum (a __shfl_xor_sync butterfly, every lane gets it)
// clipped to out_res + 8 bits.  The whole warp calls it.
__device__ __forceinline__ int adc(unsigned acc, int out_res) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int hi_out = (1 << (out_res + 7)) - 1;
  return min(max((int)acc, -hi_out - 1), hi_out);
}

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
  for (int c = threadIdx.x; c < C; c += blockDim.x) xs[c] = dac(x[(size_t)b * C + c], in_res);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= R) return;  // whole warp leaves together: the shuffles stay full
  const size_t base = (size_t)b * w_stride + (size_t)row * C;
  const bool aligned4 =
      (C & 3) == 0 && (w_stride & 3) == 0 && ((uintptr_t)w & 3) == 0 &&
      (!kFaults || (((uintptr_t)f_and | (uintptr_t)f_xor) & 3) == 0);
  unsigned acc = 0;
  if (aligned4) {  // every row starts 4-byte aligned: char4 loads
    for (int q = lane; q < (C >> 2); q += 32) {
      char4 v = load4(w, base, q, true, 0);
      if constexpr (kFaults)
        v = mask4(v, load4(f_and, base, q, true, -1), load4(f_xor, base, q, true, 0));
      acc += dot4(v, xs, q << 2);
    }
  } else {
    acc = dot_bytes<kFaults>(w, f_and, f_xor, base, xs, C, lane);
  }
  const int y = adc(acc, out_res);
  if (lane == 0) out[(size_t)b * R + row] = y;
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

// ---------------------------------------------------------------------------
// The fused quantum-boundary completion (vp/cim.finish_ops in one launch).

// Pointers of one completion, in the order of the C entry's array (18 of
// them, ops.py's FINISH_POINTERS).  Per unit (U = S * n_slots): present (one
// byte), state, busy_until, op_done_at, ops, in_count; per segment: t_end
// (S); per unit: w (U, R, C) int8, the masks f_and/f_xor (U, R, C) int8 or
// null, in_buf (U, C), out_buf (U, R); then the outputs.
struct FinishArgs {
  const uint8_t* present;
  const int32_t *state, *busy_until, *op_done_at, *ops, *in_count, *t_end;
  const int8_t *w, *f_and, *f_xor;
  const int32_t *in_buf, *out_buf;
  int32_t *out_buf_out, *state_out, *op_done_out, *ops_out, *in_count_out;
  uint8_t* done;
  int32_t* launches;  // [clean, kFaults] launch counts on the card, or null
};

FinishArgs finish_args(const void* const* p) {
  FinishArgs a;
  a.present = (const uint8_t*)p[0];
  const int32_t** scalars[] = {&a.state, &a.busy_until, &a.op_done_at, &a.ops,
                               &a.in_count, &a.t_end};
  for (int k = 0; k < 6; ++k) *scalars[k] = (const int32_t*)p[1 + k];
  a.w = (const int8_t*)p[7];
  a.f_and = (const int8_t*)p[8];
  a.f_xor = (const int8_t*)p[9];
  a.in_buf = (const int32_t*)p[10];
  a.out_buf = (const int32_t*)p[11];
  int32_t** outs[] = {&a.out_buf_out, &a.state_out, &a.op_done_out, &a.ops_out,
                      &a.in_count_out};
  for (int k = 0; k < 5; ++k) *outs[k] = (int32_t*)p[12 + k];
  a.done = (uint8_t*)p[17];
  a.launches = (int32_t*)p[18];
  return a;
}

// Today's grid, (R / 8, U) blocks of 8 warps, one warp per output row,
// C <= 256.  As in the fused tick, the time is a chain of trips to memory,
// kept at two.  Trip 1: every thread loads its unit's FSM scalars, thread t
// the input in_buf[t] and thread t < 8 the old output of row t together.
// A unit that is not done writes the old outputs through and reads no
// weights.  Trip 2, only where the unit is done: each warp loads its row's
// weights (and masks) at once, two char4 per lane; then the clipped inputs
// go to shared memory and the warp reduces its row from registers.  Block 0
// of each unit writes the unit's FSM fields and ``done``.  C % 4 != 0 (or a
// misaligned base) takes a byte loop after the inputs are staged.
template <bool kFaults>
__global__ void finish_ops_kernel(FinishArgs a, int n_slots, int R, int C, long long in_s0,
                                  long long in_s1, int st_op, int st_idle, int in_res,
                                  int out_res) {
  __shared__ int32_t xs[kXbar];  // the clipped input vector
  const int u = blockIdx.y, t = threadIdx.x;
  if (a.launches != nullptr && blockIdx.x == 0 && u == 0 && t == 0) atomicAdd(a.launches + kFaults, 1);
  const int row0 = blockIdx.x * kWarpsPerBlock;
  const size_t ur = (size_t)u * R;
  const int32_t* x = a.in_buf + (u / n_slots) * in_s0 + (u % n_slots) * in_s1;
  // trip 1
  const int busy = a.busy_until[u], st = a.state[u], te = a.t_end[u / n_slots];
  const bool here = a.present[u] != 0;
  const int xt = t < C ? x[t] : 0;
  const int old = t < kWarpsPerBlock && row0 + t < R ? a.out_buf[ur + row0 + t] : 0;
  const bool done = here && st == st_op && busy <= te;
  if (blockIdx.x == 0 && t == 0) {
    a.state_out[u] = done ? st_idle : st;
    a.op_done_out[u] = done ? busy : a.op_done_at[u];
    a.ops_out[u] = (int)((unsigned)a.ops[u] + (done ? 1u : 0u));
    a.in_count_out[u] = done ? 0 : a.in_count[u];
    a.done[u] = done ? 1 : 0;
  }
  if (!done) {
    if (t < kWarpsPerBlock && row0 + t < R) a.out_buf_out[ur + row0 + t] = old;
    return;
  }

  // trip 2
  const int row = row0 + (t >> 5), lane = t & 31;
  const int8_t* fa = kFaults ? a.f_and : nullptr;
  const int8_t* fx = kFaults ? a.f_xor : nullptr;
  const bool aligned4 = (C & 3) == 0 &&
                        (((uintptr_t)a.w | (uintptr_t)fa | (uintptr_t)fx) & 3) == 0;
  const size_t base = (ur + row) * C;
  // columns 4 * lane + (0..3) and 128 + 4 * lane + (0..3): every load is
  // issued before any is used, the masks' too
  char4 wv[2], av[2], xv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = lane + 32 * h;
    const bool in = aligned4 && row < R && 4 * q < C;
    wv[h] = load4(a.w, base, q, in, 0);
    if constexpr (kFaults) {
      av[h] = load4(fa, base, q, in, -1);
      xv[h] = load4(fx, base, q, in, 0);
    }
  }
  if constexpr (kFaults) {
#pragma unroll
    for (int h = 0; h < 2; ++h) wv[h] = mask4(wv[h], av[h], xv[h]);
  }
  if (t < C) xs[t] = dac(xt, in_res);
  __syncthreads();
  if (row >= R) return;  // whole warp leaves together: the shuffles stay full
  unsigned acc = 0;
  if (aligned4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * (lane + 32 * h);
      if (c < C) acc += dot4(wv[h], xs, c);
    }
  } else {
    acc = dot_bytes<kFaults>(a.w, fa, fx, base, xs, C, lane);
  }
  const int y = adc(acc, out_res);
  if (lane == 0) a.out_buf_out[ur + row] = y;
}

template <bool kFaults>
int finish_launch(const void* const* p, int U, int n_slots, int R, int C, long long in_s0,
                  long long in_s1, int st_op, int st_idle, int in_res, int out_res,
                  void* stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock, U);
  finish_ops_kernel<kFaults><<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      finish_args(p), n_slots, R, C, in_s0, in_s1, st_op, st_idle, in_res, out_res);
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

// The fused quantum-boundary completion: ``p`` holds 19 pointers in
// FinishArgs' order (null for an absent mask; the last, the launch counts,
// which block (0, 0) adds one to, null when not counted).  U = S * n_slots units, unit
// u of segment u / n_slots; C <= 256 (the block stages C inputs in its 256
// threads).  in_buf may be strided over its two leading axes: unit u's C
// inputs start at in_buf + (u / n_slots) * in_s0 + (u % n_slots) * in_s1
// (in elements); every other array is contiguous.  ``st_op``/``st_idle``
// are the FSM's OP and IDLE state words.  Needs U <= 65535 and 1 <=
// in_res, out_res <= 15.  Returns cudaGetLastError() after the launch.
extern "C" int finish_ops_launch(const void* const* p, int U, int n_slots, int R, int C,
                                 long long in_s0, long long in_s1, int st_op, int st_idle,
                                 int in_res, int out_res, void* stream) {
  return finish_launch<false>(p, U, n_slots, R, C, in_s0, in_s1, st_op, st_idle, in_res,
                              out_res, stream);
}

// The fault variant of the fused completion: the VMM reads W as
// (W & f_and) ^ f_xor, a null mask neutral.
extern "C" int finish_ops_faults_launch(const void* const* p, int U, int n_slots, int R,
                                        int C, long long in_s0, long long in_s1, int st_op,
                                        int st_idle, int in_res, int out_res,
                                        void* stream) {
  return finish_launch<true>(p, U, n_slots, R, C, in_s0, in_s1, st_op, st_idle, in_res,
                             out_res, stream);
}
