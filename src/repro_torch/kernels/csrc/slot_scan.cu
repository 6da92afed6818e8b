// Instruction-slot scan for Hopper (sm_90a), plain C interface.
//
// Runs one quantum of RISC-V instruction slots for every segment of the
// stack, then applies the quantum's DRAM store log in order.  It replaces the
// lax.scan over ``slot`` in src/repro/vp/platform.py::make_segment_step
// (the instruction slots, :598-627) and the store-log lax.scan after it
// (:630-635).  Same function, bit for bit, as
// src/repro_torch/kernels/slot_scan/ref.py::slot_scan.
//
// Design.  One block per segment; thread 0 runs the quantum's slots in order
// (a dependent chain of scalar work: fetch, icache, decode, execute, dcache,
// DRAM timing, memory dispatch, outbox append).  The other threads stage the
// segment's scratch SRAM, program, cache tags and registers into shared
// memory before the scan and write them out after it.  The DRAM backing
// store stays in global memory and is read-only during the scan — loads see
// the pre-quantum image, as in the reference — and the store log, kept in a
// global scratch buffer, is applied to it in order afterwards.  Outbox
// appends go to global memory at ``count``; ``count`` keeps recording demand
// past the box's capacity.  A slot whose CPU cannot run (absent, halted,
// waiting on a remote read, or at the decoupling bound) stays that way for
// the rest of the quantum, so the remaining slots' effect — one cycle each
// on a live CPU's clock, capped at t_limit — is applied in closed form and
// the thread leaves the loop.  The reference's int32 arithmetic wraps: the
// ALU works in uint32 and reinterprets; right shifts of int32 values stay
// arithmetic.
//
// Bound.  Latency, not bytes: each slot is a chain of ~100 dependent scalar
// operations and shared-memory accesses on one thread, plus a global load
// for a DRAM access.  The bytes the scan must move (its state in and out,
// about 40 KB a segment, plus the DRAM words it reads) take a few
// nanoseconds at 3.35 TB/s; a 10,000-slot quantum takes milliseconds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pointer arguments, in the order of ops.py's POINTERS
enum Ptr {
  P_TIME, P_SEG_ID, P_DRAM_PRESENT, P_PRESENT, P_HALTED, P_WAITING, P_PC,
  P_REGS, P_INSTRET, P_PROG, P_ITAGS, P_IHITS, P_IMISSES, P_DTAGS, P_DHITS,
  P_DMISSES, P_LAST_ROW, P_LAST_WRITE, P_READS, P_WRITES, P_SCRATCH,
  P_INSTRS, P_MMIO_LATE, P_STORE_PEAK, P_T_LIMIT, P_CIM_SEG, P_CIM_SLOT,
  // updated in place
  P_DRAM, P_OB_KIND, P_OB_DST, P_OB_ADDR, P_OB_DATA, P_OB_T_EMIT, P_OB_VALID,
  P_OB_COUNT,
  // outputs
  O_TIME, O_HALTED, O_WAITING, O_PC, O_REGS, O_INSTRET, O_ITAGS, O_IHITS,
  O_IMISSES, O_DTAGS, O_DHITS, O_DMISSES, O_LAST_ROW, O_LAST_WRITE, O_READS,
  O_WRITES, O_SCRATCH, O_INSTRS, O_MMIO_LATE, O_STORE_PEAK,
  // scratch: the store log, (S, 2, store_log)
  P_LOG,
  N_PTRS
};

// integer arguments, in the order of ops.py's INTS
enum Int {
  I_QUANTUM, I_OUT_CAP, I_STORE_LOG, I_N_CIM, I_DRAM_SEGMENT, I_CPI,
  I_SCRATCH_CYCLES, I_CACHE_HIT, I_DRAM_ACCESS, I_PAGE_SWITCH, I_WRITE_READ_SWITCH, I_IMISS, I_MMIO_POST,
  I_DRAM_ROW_BITS, I_LINE_WORDS, I_ISETS, I_DSETS, I_DRAM_WORDS,
  I_SCRATCH_WORDS, I_PROG_WORDS,
  N_INTS
};

struct Params {
  void* p[N_PTRS];
  int n[N_INTS];
};

// memory map and message kinds (repro_torch/vp/isa.py, core/channel.py)
constexpr int32_t kCimBase = 0x40000000;
constexpr int32_t kScratchBase = 0x70000000;
constexpr int kCimRegSpike = 0x20;
constexpr int kMsgWDram = 0, kMsgWCim = 1, kMsgRDram = 3;
// RV32 opcodes
constexpr int kOpLui = 0x37, kOpAuipc = 0x17, kOpJal = 0x6F, kOpJalr = 0x67,
              kOpBranch = 0x63, kOpLoad = 0x03, kOpStore = 0x23,
              kOpImm = 0x13, kOpReg = 0x33;

template <typename T>
__device__ __forceinline__ T* ptr(const Params& P, int i) {
  return static_cast<T*>(P.p[i]);
}

// sign-extend the low ``bits`` bits of v
__device__ __forceinline__ int32_t sx(uint32_t v, int bits) {
  const uint32_t sign = 1u << (bits - 1);
  v &= (sign << 1) - 1u;
  return (int32_t)((v ^ sign) - sign);
}

__device__ void run_segment(const Params& P, int s, int32_t* scratch,
                            const uint32_t* prog, int32_t* itags,
                            int32_t* dtags, int32_t* regs) {
  const int* n = P.n;
  const int quantum = n[I_QUANTUM], cap = n[I_OUT_CAP], store_log = n[I_STORE_LOG];
  const int n_cim = n[I_N_CIM], line_words = n[I_LINE_WORDS];
  const int isets = n[I_ISETS], dsets = n[I_DSETS];
  const int scratch_words = n[I_SCRATCH_WORDS], prog_words = n[I_PROG_WORDS];
  const long long dram_words = n[I_DRAM_WORDS];

  const int32_t t_limit = ptr<const int32_t>(P, P_T_LIMIT)[s];
  const int32_t seg_id = ptr<const int32_t>(P, P_SEG_ID)[s];
  const bool dram_present = ptr<const uint8_t>(P, P_DRAM_PRESENT)[s] != 0;
  const bool present = ptr<const uint8_t>(P, P_PRESENT)[s] != 0;
  bool halted = ptr<const uint8_t>(P, P_HALTED)[s] != 0;
  bool waiting = ptr<const uint8_t>(P, P_WAITING)[s] != 0;
  int32_t time = ptr<const int32_t>(P, P_TIME)[s];
  int32_t pc = ptr<const int32_t>(P, P_PC)[s];
  int32_t instret = ptr<const int32_t>(P, P_INSTRET)[s];
  int32_t ihits = ptr<const int32_t>(P, P_IHITS)[s];
  int32_t imisses = ptr<const int32_t>(P, P_IMISSES)[s];
  int32_t dhits = ptr<const int32_t>(P, P_DHITS)[s];
  int32_t dmisses = ptr<const int32_t>(P, P_DMISSES)[s];
  int32_t last_row = ptr<const int32_t>(P, P_LAST_ROW)[s];
  bool last_write = ptr<const uint8_t>(P, P_LAST_WRITE)[s] != 0;
  int32_t reads = ptr<const int32_t>(P, P_READS)[s];
  int32_t writes = ptr<const int32_t>(P, P_WRITES)[s];
  int32_t instrs = ptr<const int32_t>(P, P_INSTRS)[s];
  int32_t mmio_late = ptr<const int32_t>(P, P_MMIO_LATE)[s];
  int32_t ob_count = ptr<const int32_t>(P, P_OB_COUNT)[s];
  int32_t log_count = 0;

  int32_t* dram = ptr<int32_t>(P, P_DRAM) + s * dram_words;
  int32_t* log_addr = ptr<int32_t>(P, P_LOG) + (size_t)s * 2 * store_log;
  int32_t* log_data = log_addr + store_log;
  const int32_t* cim_seg = ptr<const int32_t>(P, P_CIM_SEG);
  const int32_t* cim_slot = ptr<const int32_t>(P, P_CIM_SLOT);
  const size_t ob = (size_t)s * cap;
  int32_t* ob_kind = ptr<int32_t>(P, P_OB_KIND) + ob;
  int32_t* ob_dst = ptr<int32_t>(P, P_OB_DST) + ob;
  int32_t* ob_addr = ptr<int32_t>(P, P_OB_ADDR) + ob;
  int32_t* ob_data = ptr<int32_t>(P, P_OB_DATA) + ob;
  int32_t* ob_t = ptr<int32_t>(P, P_OB_T_EMIT) + ob;
  uint8_t* ob_valid = ptr<uint8_t>(P, P_OB_VALID) + ob;
  auto append = [&](int kind, int32_t dst, int32_t addr, int32_t data, int32_t t) {
    if (ob_count < cap) {  // past capacity: dropped, the count records demand
      ob_kind[ob_count] = kind;
      ob_dst[ob_count] = dst;
      ob_addr[ob_count] = addr;
      ob_data[ob_count] = data;
      ob_t[ob_count] = t;
      ob_valid[ob_count] = 1;
    }
    ++ob_count;
  };

  for (int q = 0; q < quantum; ++q) {
    const bool live = present && !halted;
    if (!(live && !waiting && time < t_limit)) {
      // not runnable now means not runnable for the rest of the quantum:
      // each remaining slot costs a live CPU one cycle, capped at t_limit
      if (live) {
        const long long t2 = (long long)time + (quantum - q);
        time = (int32_t)(t2 < t_limit ? t2 : t_limit);
      }
      break;
    }
    // ---- fetch + icache
    const int pc_w = (pc >> 2) & (prog_words - 1);
    const uint32_t u = prog[pc_w];
    const int iline = pc_w / line_words;
    const int iset = iline % isets;
    const bool ihit = itags[iset] == iline;
    itags[iset] = iline;
    if (ihit) ++ihits; else ++imisses;

    // ---- decode
    const int op = u & 0x7F, rd = (u >> 7) & 31, f3 = (u >> 12) & 7;
    const int rs1 = (u >> 15) & 31, rs2 = (u >> 20) & 31, f7 = (u >> 25) & 0x7F;
    const int32_t imm_i = sx(u >> 20, 12);
    const int32_t imm_s = sx(((uint32_t)f7 << 5) | rd, 12);
    const int32_t imm_b = sx((((u >> 31) & 1u) << 12) | (((u >> 7) & 1u) << 11) |
                             (((u >> 25) & 0x3Fu) << 5) | (((u >> 8) & 0xFu) << 1), 13);
    const int32_t imm_u = (int32_t)(u & 0xFFFFF000u);
    const int32_t imm_j = sx((((u >> 31) & 1u) << 20) | (((u >> 12) & 0xFFu) << 12) |
                             (((u >> 20) & 1u) << 11) | (((u >> 21) & 0x3FFu) << 1), 21);

    // ---- execute (branchless classes, as the reference)
    const uint32_t a = (uint32_t)regs[rs1], b = (uint32_t)regs[rs2];
    const bool is_lui = op == kOpLui, is_auipc = op == kOpAuipc;
    const bool is_jal = op == kOpJal, is_jalr = op == kOpJalr;
    const bool is_br = op == kOpBranch, is_load = op == kOpLoad;
    const bool is_store = op == kOpStore, is_imm = op == kOpImm, is_reg = op == kOpReg;
    const bool is_sub = is_reg && f7 == 0x20, is_mul = is_reg && f7 == 0x01;
    const uint32_t alu = is_mul ? a * b : is_sub ? a - b : a + (is_imm ? (uint32_t)imm_i : b);
    const bool taken = (f3 == 0 && a == b) || (f3 == 1 && a != b) ||
                       (f3 == 4 && (int32_t)a < (int32_t)b) ||
                       (f3 == 5 && (int32_t)a >= (int32_t)b);
    const uint32_t upc = (uint32_t)pc;
    uint32_t next_pc = upc + 4u;
    if (is_br && taken) next_pc = upc + (uint32_t)imm_b;
    if (is_jal) next_pc = upc + (uint32_t)imm_j;
    if (is_jalr) next_pc = (a + (uint32_t)imm_i) & ~1u;
    uint32_t wb = alu;
    if (is_lui) wb = (uint32_t)imm_u;
    if (is_auipc) wb = upc + (uint32_t)imm_u;
    if (is_jal || is_jalr) wb = upc + 4u;
    if ((is_lui || is_auipc || is_jal || is_jalr || is_imm || is_reg) && rd != 0)
      regs[rd] = (int32_t)wb;
    regs[0] = 0;
    halted = is_jal && rd == 0 && imm_j == 0;  // jal x0, 0 halts
    if (!halted) pc = (int32_t)next_pc;
    instret += halted ? 0 : 1;
    const bool ld = is_load && !halted, sd = is_store && !halted;
    const int32_t addr = (int32_t)(a + (uint32_t)(is_store ? imm_s : imm_i));
    const int32_t st_data = (int32_t)b;

    // ---- memory dispatch (the reference's _mem_access)
    const int32_t widx = (addr >> 2) & (int32_t)(dram_words - 1);
    const bool is_scratch = addr >= kScratchBase && addr < kScratchBase + scratch_words * 4;
    const bool is_cim = addr >= kCimBase && addr < kScratchBase;
    const bool is_dram = addr >= 0 && addr < kCimBase;
    const bool use_dram_r = ld && is_dram && dram_present;
    const bool local_w = sd && is_dram && dram_present;
    const bool touch = use_dram_r || local_w;
    const int dline = widx / line_words;
    const int dset = dline % dsets;
    const bool hit = dtags[dset] == dline;
    if (touch) {
      dtags[dset] = dline;
      if (hit) ++dhits; else ++dmisses;
    }
    const int32_t row = widx >> n[I_DRAM_ROW_BITS];
    const int dcost = n[I_DRAM_ACCESS] + (row != last_row ? n[I_PAGE_SWITCH] : 0) +
                      (last_write && !local_w ? n[I_WRITE_READ_SWITCH] : 0);
    if (touch && !hit) {
      last_row = row;
      last_write = local_w;
      if (local_w) ++writes; else ++reads;
    }
    const int dram_c = hit ? n[I_CACHE_HIT] : dcost;
    const int s_idx = is_scratch ? (addr - kScratchBase) >> 2 : 0;
    int mcycles = 0;
    if (ld) mcycles = is_scratch ? n[I_SCRATCH_CYCLES] : use_dram_r ? dram_c : n[I_CPI];
    const bool remote_ld = ld && is_dram && !dram_present;
    if (remote_ld)  // blocking request, tag = seg_id << 8 | rd
      append(kMsgRDram, n[I_DRAM_SEGMENT], widx, (seg_id << 8) | rd, time);
    if (sd && is_scratch) scratch[s_idx] = st_data;
    if (local_w) {
      const int li = min(max(log_count, 0), store_log - 1);  // clips onto the last entry
      log_addr[li] = widx;
      log_data[li] = st_data;
      ++log_count;
    }
    if (sd) mcycles += is_scratch ? n[I_SCRATCH_CYCLES] : local_w ? dram_c : n[I_MMIO_POST];
    if (sd && is_dram && !dram_present)
      append(kMsgWDram, n[I_DRAM_SEGMENT], widx, st_data, time);
    if (n_cim > 0 && sd && is_cim) {
      const int g = min(max((addr - kCimBase) >> 12, 0), n_cim - 1);
      const int32_t reg_off = addr & 0xFFF;
      const int32_t seg_u = cim_seg[g], slot_u = cim_slot[g];
      if (reg_off == kCimRegSpike) {
        // late MMIO, as on a platform without ticking units: a live CPU
        // beside ticking units (tick-addressed AER injection) is a hybrid
        // job, which the controller refuses
        ++mmio_late;
      } else {
        append(kMsgWCim, seg_u, (slot_u << 16) | reg_off, st_data, time);
      }
    }
    if (ld) {
      if (remote_ld) {
        waiting = true;  // stalls until the response arrives
      } else {
        regs[rd] = is_scratch ? scratch[s_idx] : dram[widx];
        regs[0] = 0;
      }
    }
    const int32_t cost = n[I_CPI] + mcycles + (ihit ? 0 : n[I_IMISS]);
    time = time + cost < t_limit ? time + cost : t_limit;
    ++instrs;
  }

  // the DRAM store log, in order
  const int n_log = min(log_count, store_log);
  for (int i = 0; i < n_log; ++i) dram[log_addr[i]] = log_data[i];

  const int32_t peak = ptr<const int32_t>(P, P_STORE_PEAK)[s];
  ptr<int32_t>(P, O_TIME)[s] = time;
  ptr<uint8_t>(P, O_HALTED)[s] = halted;
  ptr<uint8_t>(P, O_WAITING)[s] = waiting;
  ptr<int32_t>(P, O_PC)[s] = pc;
  ptr<int32_t>(P, O_INSTRET)[s] = instret;
  ptr<int32_t>(P, O_IHITS)[s] = ihits;
  ptr<int32_t>(P, O_IMISSES)[s] = imisses;
  ptr<int32_t>(P, O_DHITS)[s] = dhits;
  ptr<int32_t>(P, O_DMISSES)[s] = dmisses;
  ptr<int32_t>(P, O_LAST_ROW)[s] = last_row;
  ptr<uint8_t>(P, O_LAST_WRITE)[s] = last_write;
  ptr<int32_t>(P, O_READS)[s] = reads;
  ptr<int32_t>(P, O_WRITES)[s] = writes;
  ptr<int32_t>(P, O_INSTRS)[s] = instrs;
  ptr<int32_t>(P, O_MMIO_LATE)[s] = mmio_late;
  ptr<int32_t>(P, O_STORE_PEAK)[s] = peak > log_count ? peak : log_count;
  ptr<int32_t>(P, P_OB_COUNT)[s] = ob_count;
}

__global__ void slot_scan_kernel(const Params P) {
  extern __shared__ int32_t sh[];
  const int s = blockIdx.x;
  const int sw = P.n[I_SCRATCH_WORDS], pw = P.n[I_PROG_WORDS];
  const int isets = P.n[I_ISETS], dsets = P.n[I_DSETS];
  int32_t* scratch = sh;
  uint32_t* prog = reinterpret_cast<uint32_t*>(scratch + sw);
  int32_t* itags = reinterpret_cast<int32_t*>(prog + pw);
  int32_t* dtags = itags + isets;
  int32_t* regs = dtags + dsets;
  for (int i = threadIdx.x; i < sw; i += blockDim.x)
    scratch[i] = ptr<const int32_t>(P, P_SCRATCH)[(size_t)s * sw + i];
  for (int i = threadIdx.x; i < pw; i += blockDim.x)
    prog[i] = ptr<const uint32_t>(P, P_PROG)[(size_t)s * pw + i];
  for (int i = threadIdx.x; i < isets; i += blockDim.x)
    itags[i] = ptr<const int32_t>(P, P_ITAGS)[(size_t)s * isets + i];
  for (int i = threadIdx.x; i < dsets; i += blockDim.x)
    dtags[i] = ptr<const int32_t>(P, P_DTAGS)[(size_t)s * dsets + i];
  if (threadIdx.x < 32) regs[threadIdx.x] = ptr<const int32_t>(P, P_REGS)[s * 32 + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) run_segment(P, s, scratch, prog, itags, dtags, regs);
  __syncthreads();
  for (int i = threadIdx.x; i < sw; i += blockDim.x)
    ptr<int32_t>(P, O_SCRATCH)[(size_t)s * sw + i] = scratch[i];
  for (int i = threadIdx.x; i < isets; i += blockDim.x)
    ptr<int32_t>(P, O_ITAGS)[(size_t)s * isets + i] = itags[i];
  for (int i = threadIdx.x; i < dsets; i += blockDim.x)
    ptr<int32_t>(P, O_DTAGS)[(size_t)s * dsets + i] = dtags[i];
  if (threadIdx.x < 32) ptr<int32_t>(P, O_REGS)[s * 32 + threadIdx.x] = regs[threadIdx.x];
}

}  // namespace

// Launches one block per segment on ``stream``; returns cudaGetLastError()
// after the launch (0 on success), or -1 when the caller's argument counts
// differ from this build's.  ``ptrs`` holds N_PTRS device pointers and
// ``ints`` N_INTS integers, in the orders above.
extern "C" int slot_scan_launch(void* const* ptrs, int n_ptrs, const int* ints,
                                int n_ints, int n_segments, void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS) return -1;
  Params P;
  for (int i = 0; i < N_PTRS; ++i) P.p[i] = ptrs[i];
  for (int i = 0; i < N_INTS; ++i) P.n[i] = ints[i];
  const size_t shmem = sizeof(int32_t) *
      (size_t)(P.n[I_SCRATCH_WORDS] + P.n[I_PROG_WORDS] + P.n[I_ISETS] + P.n[I_DSETS] + 32);
  slot_scan_kernel<<<n_segments, 256, shmem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
