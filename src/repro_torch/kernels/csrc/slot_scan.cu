// Instruction-slot scan for Hopper (sm_90a), plain C interface.
//
// Runs one quantum of RISC-V instruction slots for every segment of the
// stack, then applies the quantum's DRAM store log in order.  It replaces the
// lax.scan over ``slot`` in src/repro/vp/platform.py::make_segment_step
// (the instruction slots, :598-627) and the store-log lax.scan after it
// (:630-635).  Same function, bit for bit, as
// src/repro_torch/kernels/slot_scan/ref.py::slot_scan.
//
// Design.  One block per segment.  The block's threads first decode the
// segment's program once into a table in shared memory (a quantum cannot
// change the program): one 16-byte entry per word with the instruction
// class, rd/rs1/rs2, the one immediate the class uses, the branch or ALU
// sub-op, the halt flag of ``jal x0, 0``, and the word's icache line and set.
// They also stage the scratch SRAM, cache tags and registers.  Thread 0 then
// runs the quantum's slots in order, a dependent chain of scalar work: one
// shared load of the decoded entry, the icache tag, a ``switch`` that runs
// only the current class's arm, and the memory dispatch (dcache, DRAM row
// and write state, store log, outbox) only for loads and stores.  Cache
// geometry arrives as shifts and masks (all sizes are powers of two), so no
// slot divides.  The DRAM backing store stays in global memory and is
// read-only during the scan — loads see the pre-quantum image, as in the
// reference, through the read-only data cache — and the store log, kept in a
// global scratch buffer, is applied to it in order afterwards.  Outbox
// appends go to global memory at ``count``; ``count`` keeps recording demand
// past the box's capacity.  On a platform with ticking spike-mode units
// (``tick_period`` > 0, a hybrid job) a CIM_REG_SPIKE store becomes a
// tick-addressed AER spike in place of the MSG_W_CIM it does not send
// (reference :477-503), with the tick's grid time backed out of its t_emit.  The reference's int32 arithmetic wraps: the ALU
// works in uint32 and reinterprets; right shifts of int32 values stay
// arithmetic.
//
// Two closed forms skip slots whose effect is known.  (1) A slot whose CPU
// cannot run (absent, halted, waiting on a remote read, or at the
// decoupling bound) stays that way for the rest of the quantum, so the
// remaining slots' effect — one cycle each on a live CPU's clock, capped at
// t_limit — is applied at once and the thread leaves the loop.  (2) A loop
// at a fixed point is fast-forwarded.  At each taken backward branch or jump
// the thread notes the pc and its counters and clears a dirty flag; any
// change other than to the counters (a register written with a new value, a
// scratch or DRAM store, an outbox append, an MMIO late count, a cache miss
// — which is the only way cache tags, the DRAM row and write state change —
// or the CPU halting or waiting) sets it.  When the same branch is taken
// again with the flag clear, every piece of state that steers execution is
// what it was one iteration earlier (loads read the pre-quantum DRAM image
// and the unchanged scratch), so each further iteration repeats this one:
// the same L slots and the same deltas of time, instret, instrs and cache
// hits.  The thread adds k of them at once, for the largest k that leaves at
// least one whole iteration to run and keeps every skipped slot runnable with
// its clock below t_limit (so no cap fires inside them); the ordinary loop
// runs the rest slot by slot, so the quantum's end and t_limit come out as
// in the plain version.  The polling loops of the offload manager (a scratch
// load and a branch, waiting for a flag that only a message between rounds
// can set) are the case this is for.  The count of skipped slots per segment
// is written after the store log's entries in the scratch buffer.
//
// Bound.  Latency, not bytes: each executed slot is a chain of a few dozen
// dependent scalar operations and shared-memory accesses on one thread, plus
// a global load for a DRAM access.  The bytes the scan must move (its state
// in and out, about 40 KB a segment, plus the DRAM words it reads) take a
// few nanoseconds at 3.35 TB/s; a 10,000-slot quantum takes tens to
// thousands of microseconds.
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
  // scratch: (S, 2 * store_log + 1), the store log's addresses and data,
  // then the count of fast-forwarded slots
  P_LOG,
  // the launch counts on the card, which block 0 adds one to (or null)
  P_LAUNCHES,
  N_PTRS
};

// integer arguments, in the order of ops.py's INTS
enum Int {
  I_QUANTUM, I_OUT_CAP, I_STORE_LOG, I_N_CIM, I_DRAM_SEGMENT, I_CPI,
  I_SCRATCH_CYCLES, I_CACHE_HIT, I_DRAM_ACCESS, I_PAGE_SWITCH, I_WRITE_READ_SWITCH, I_IMISS, I_MMIO_POST,
  I_DRAM_ROW_BITS, I_LINE_SHIFT, I_ISET_MASK, I_DSET_MASK, I_DRAM_WORDS,
  I_SCRATCH_WORDS, I_PROG_WORDS,
  // tick-addressed CIM_REG_SPIKE injection: the platform's LIF tick period
  // (0: no ticking unit wired) and its two routing latencies
  I_TICK_PERIOD, I_LOCAL_LATENCY, I_CHANNEL_LATENCY,
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
constexpr int kMsgWDram = 0, kMsgWCim = 1, kMsgRDram = 3, kMsgSpike = 5;
// RV32 opcodes
constexpr int kOpLui = 0x37, kOpAuipc = 0x17, kOpJal = 0x6F, kOpJalr = 0x67,
              kOpBranch = 0x63, kOpLoad = 0x03, kOpStore = 0x23,
              kOpImm = 0x13, kOpReg = 0x33;
// instruction classes of the decoded table; kOther only advances the pc
enum Cls { kOther, kLui, kAuipc, kJal, kJalr, kBranch, kLoad, kStore, kImm, kReg };
// sub-ops: a branch's f3, or the register ALU's add / sub / mul
constexpr int kAdd = 0, kSub = 1, kMul = 2;

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

// One decoded program word: x = class | rd << 4 | rs1 << 9 | rs2 << 14 |
// sub-op << 19 | halt << 22; y = the class's immediate; z = icache line;
// w = icache set.
__device__ __forceinline__ uint4 predecode(uint32_t u, int word, int line_shift,
                                           int iset_mask) {
  const int op = u & 0x7F, rd = (u >> 7) & 31, f3 = (u >> 12) & 7;
  const int rs1 = (u >> 15) & 31, rs2 = (u >> 20) & 31, f7 = (u >> 25) & 0x7F;
  int cls = kOther, sub = 0, halt = 0;
  int32_t imm = 0;
  switch (op) {
    case kOpLui: cls = kLui; imm = (int32_t)(u & 0xFFFFF000u); break;
    case kOpAuipc: cls = kAuipc; imm = (int32_t)(u & 0xFFFFF000u); break;
    case kOpJal:
      cls = kJal;
      imm = sx((((u >> 31) & 1u) << 20) | (((u >> 12) & 0xFFu) << 12) |
               (((u >> 20) & 1u) << 11) | (((u >> 21) & 0x3FFu) << 1), 21);
      halt = rd == 0 && imm == 0;  // jal x0, 0 halts
      break;
    case kOpJalr: cls = kJalr; imm = sx(u >> 20, 12); break;
    case kOpBranch:
      cls = kBranch;
      sub = f3;
      imm = sx((((u >> 31) & 1u) << 12) | (((u >> 7) & 1u) << 11) |
               (((u >> 25) & 0x3Fu) << 5) | (((u >> 8) & 0xFu) << 1), 13);
      break;
    case kOpLoad: cls = kLoad; imm = sx(u >> 20, 12); break;
    case kOpStore: cls = kStore; imm = sx(((uint32_t)f7 << 5) | rd, 12); break;
    case kOpImm: cls = kImm; imm = sx(u >> 20, 12); break;
    case kOpReg: cls = kReg; sub = f7 == 0x01 ? kMul : f7 == 0x20 ? kSub : kAdd; break;
    default: break;
  }
  const int iline = word >> line_shift;
  return make_uint4((uint32_t)cls | (uint32_t)rd << 4 | (uint32_t)rs1 << 9 |
                        (uint32_t)rs2 << 14 | (uint32_t)sub << 19 | (uint32_t)halt << 22,
                    (uint32_t)imm, (uint32_t)iline, (uint32_t)(iline & iset_mask));
}

__device__ void run_segment(const Params& P, int s, int32_t* scratch,
                            const uint4* table, int32_t* itags,
                            int32_t* dtags, int32_t* regs) {
  const int* n = P.n;
  const int quantum = n[I_QUANTUM], cap = n[I_OUT_CAP], store_log = n[I_STORE_LOG];
  const int n_cim = n[I_N_CIM], line_shift = n[I_LINE_SHIFT];
  const int dset_mask = n[I_DSET_MASK], row_bits = n[I_DRAM_ROW_BITS];
  const int cpi = n[I_CPI], scratch_cycles = n[I_SCRATCH_CYCLES];
  const int cache_hit = n[I_CACHE_HIT], imiss = n[I_IMISS], mmio_post = n[I_MMIO_POST];
  const int scratch_words = n[I_SCRATCH_WORDS], prog_mask = n[I_PROG_WORDS] - 1;
  const int32_t dram_mask = n[I_DRAM_WORDS] - 1;
  const long long dram_words = n[I_DRAM_WORDS];

  const int32_t t_limit = ptr<const int32_t>(P, P_T_LIMIT)[s];
  const int32_t seg_id = ptr<const int32_t>(P, P_SEG_ID)[s];
  const bool dram_present = ptr<const uint8_t>(P, P_DRAM_PRESENT)[s] != 0;
  const bool present = ptr<const uint8_t>(P, P_PRESENT)[s] != 0;
  bool halted = ptr<const uint8_t>(P, P_HALTED)[s] != 0;
  bool waiting = ptr<const uint8_t>(P, P_WAITING)[s] != 0;
  int32_t time = ptr<const int32_t>(P, P_TIME)[s];
  int32_t pc = ptr<const int32_t>(P, P_PC)[s];
  uint32_t instret = ptr<const int32_t>(P, P_INSTRET)[s];
  uint32_t ihits = ptr<const int32_t>(P, P_IHITS)[s];
  int32_t imisses = ptr<const int32_t>(P, P_IMISSES)[s];
  uint32_t dhits = ptr<const int32_t>(P, P_DHITS)[s];
  int32_t dmisses = ptr<const int32_t>(P, P_DMISSES)[s];
  int32_t last_row = ptr<const int32_t>(P, P_LAST_ROW)[s];
  bool last_write = ptr<const uint8_t>(P, P_LAST_WRITE)[s] != 0;
  int32_t reads = ptr<const int32_t>(P, P_READS)[s];
  int32_t writes = ptr<const int32_t>(P, P_WRITES)[s];
  uint32_t instrs = ptr<const int32_t>(P, P_INSTRS)[s];
  int32_t mmio_late = ptr<const int32_t>(P, P_MMIO_LATE)[s];
  int32_t ob_count = ptr<const int32_t>(P, P_OB_COUNT)[s];
  int32_t log_count = 0;

  // the backing is read-only until the store log is applied after the loop,
  // so its words come through the read-only data cache (__ldg)
  const int32_t* backing = ptr<const int32_t>(P, P_DRAM) + s * dram_words;
  int32_t* log_addr = ptr<int32_t>(P, P_LOG) + (size_t)s * (2 * store_log + 1);
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

  // the fast-forward's anchor: the last taken backward branch or jump, the
  // slot after it, and the counters there
  bool dirty = true;
  int32_t anchor_pc = 0;
  int a_q = 0;
  int32_t a_time = 0;
  uint32_t a_instret = 0, a_ihits = 0, a_dhits = 0, a_instrs = 0;
  int skipped = 0;

  auto append = [&](int kind, int32_t dst, int32_t addr, int32_t data, int32_t t_emit) {
    if (ob_count < cap) {  // past capacity: dropped, the count records demand
      ob_kind[ob_count] = kind;
      ob_dst[ob_count] = dst;
      ob_addr[ob_count] = addr;
      ob_data[ob_count] = data;
      ob_t[ob_count] = t_emit;
      ob_valid[ob_count] = 1;
    }
    ++ob_count;
    dirty = true;
  };
  auto set_reg = [&](int rd, uint32_t v) {
    if (rd != 0 && (uint32_t)regs[rd] != v) {
      regs[rd] = (int32_t)v;
      dirty = true;
    }
  };
  // a local DRAM access: dcache, then the row-buffer and write->read timing
  // on a miss; returns its cycles
  auto dram_touch = [&](int32_t widx, bool is_write) -> int {
    const int32_t dline = widx >> line_shift;
    const int dset = dline & dset_mask;
    if (dtags[dset] == dline) {
      ++dhits;
      return cache_hit;
    }
    const int32_t row = widx >> row_bits;
    const int c = n[I_DRAM_ACCESS] + (row != last_row ? n[I_PAGE_SWITCH] : 0) +
                  (last_write && !is_write ? n[I_WRITE_READ_SWITCH] : 0);
    dtags[dset] = dline;
    ++dmisses;
    last_row = row;
    last_write = is_write;
    if (is_write) ++writes; else ++reads;
    dirty = true;
    return c;
  };

  // the reference pins x0 to 0 at every slot that runs
  if (present && !halted && !waiting && time < t_limit && quantum > 0) regs[0] = 0;
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
    // ---- fetch (decoded) + icache
    const uint4 e = table[(pc >> 2) & prog_mask];
    const int32_t iline = (int32_t)e.z;
    const bool ihit = itags[e.w] == iline;
    if (ihit) {
      ++ihits;
    } else {
      itags[e.w] = iline;
      ++imisses;
      dirty = true;
    }
    const int cls = e.x & 15, rd = (e.x >> 4) & 31;
    const int sub = (e.x >> 19) & 7;
    const uint32_t imm = e.y;
    const uint32_t a = (uint32_t)regs[(e.x >> 9) & 31];
    const uint32_t b = (uint32_t)regs[(e.x >> 14) & 31];
    const uint32_t upc = (uint32_t)pc;
    uint32_t next_pc = upc + 4u;
    bool jumped = false;  // a taken branch or jump
    int cost = cpi + (ihit ? 0 : imiss);

    // ---- execute: only the current class's arm
    switch (cls) {
      case kLui: set_reg(rd, imm); break;
      case kAuipc: set_reg(rd, upc + imm); break;
      case kJal:
        if ((e.x >> 22) & 1) {
          halted = true;  // jal x0, 0: the pc stays, instret does not count it
          dirty = true;
        } else {
          next_pc = upc + imm;
          jumped = true;
          set_reg(rd, upc + 4u);
        }
        break;
      case kJalr:
        next_pc = (a + imm) & ~1u;
        jumped = true;
        set_reg(rd, upc + 4u);
        break;
      case kBranch: {
        const bool taken = (sub == 0 && a == b) || (sub == 1 && a != b) ||
                           (sub == 4 && (int32_t)a < (int32_t)b) ||
                           (sub == 5 && (int32_t)a >= (int32_t)b);
        if (taken) {
          next_pc = upc + imm;
          jumped = true;
        }
        break;
      }
      case kImm: set_reg(rd, a + imm); break;
      case kReg: set_reg(rd, sub == kMul ? a * b : sub == kSub ? a - b : a + b); break;
      case kLoad: {
        // the reference's _mem_access for a load
        const int32_t addr = (int32_t)(a + imm);
        const int32_t widx = (addr >> 2) & dram_mask;
        if (addr >= kScratchBase && addr < kScratchBase + scratch_words * 4) {
          cost += scratch_cycles;
          set_reg(rd, (uint32_t)scratch[(addr - kScratchBase) >> 2]);
        } else if (addr >= 0 && addr < kCimBase) {
          if (dram_present) {
            cost += dram_touch(widx, false);
            set_reg(rd, (uint32_t)__ldg(backing + widx));
          } else {  // blocking request, tag = seg_id << 8 | rd; stalls
            append(kMsgRDram, n[I_DRAM_SEGMENT], widx, (seg_id << 8) | rd, time);
            cost += cpi;
            waiting = true;
          }
        } else {  // CIM or unmapped: the backing's word at widx
          cost += cpi;
          set_reg(rd, (uint32_t)__ldg(backing + widx));
        }
        break;
      }
      case kStore: {
        const int32_t addr = (int32_t)(a + imm);
        const int32_t widx = (addr >> 2) & dram_mask;
        const int32_t st_data = (int32_t)b;
        dirty = true;
        if (addr >= kScratchBase && addr < kScratchBase + scratch_words * 4) {
          scratch[(addr - kScratchBase) >> 2] = st_data;
          cost += scratch_cycles;
        } else if (addr >= 0 && addr < kCimBase) {
          if (dram_present) {
            cost += dram_touch(widx, true);
            const int li = min(log_count, store_log - 1);  // clips onto the last entry
            log_addr[li] = widx;
            log_data[li] = st_data;
            ++log_count;
          } else {
            append(kMsgWDram, n[I_DRAM_SEGMENT], widx, st_data, time);
            cost += mmio_post;
          }
        } else {
          cost += mmio_post;
          if (n_cim > 0 && addr >= kCimBase && addr < kScratchBase) {
            const int g = min(max((addr - kCimBase) >> 12, 0), n_cim - 1);
            const int32_t reg_off = addr & 0xFFF;
            const int period = n[I_TICK_PERIOD];
            if (reg_off != kCimRegSpike) {
              append(kMsgWCim, cim_seg[g], (cim_slot[g] << 16) | reg_off, st_data, time);
            } else if (period > 0) {
              // tick-addressed AER injection: a spike for tick k whose
              // t_avail is the tick's grid time (k+1)*period, the routing
              // latency backed out of t_emit; stored at or after that time
              // it is late.  The products wrap in uint32, as the
              // reference's int32 arithmetic does.  The store set ``dirty``
              // above, so no fast-forward skips it.
              const uint32_t tick = ((uint32_t)st_data >> 16) & 0x7FFFu;
              const int32_t target = (int32_t)((tick + 1u) * (uint32_t)period);
              const int32_t lat = cim_seg[g] == seg_id ? n[I_LOCAL_LATENCY]
                                                       : n[I_CHANNEL_LATENCY];
              if (time >= target) ++mmio_late;
              append(kMsgSpike, cim_seg[g], (cim_slot[g] << 16) | (st_data & 0xFFFF), 1,
                     (int32_t)((uint32_t)target - (uint32_t)lat));
            } else {
              ++mmio_late;  // no ticking spike-mode unit wired: never valid
            }
          }
        }
        break;
      }
      default: break;
    }
    if (!halted) {
      pc = (int32_t)next_pc;
      ++instret;
    }
    time = time + cost < t_limit ? time + cost : t_limit;
    ++instrs;

    // ---- fast-forward a loop at a fixed point
    if (jumped && next_pc <= upc) {
      if ((int32_t)upc == anchor_pc && !dirty && time < t_limit) {
        const int L = q + 1 - a_q;
        const uint32_t d_time = (uint32_t)(time - a_time);
        long long k = (long long)(quantum - q - 1) / L;
        if (d_time > 0) {
          const long long k_t = ((long long)t_limit - 1 - time) / d_time;
          k = k < k_t ? k : k_t;
        }
        k -= 1;  // the last whole iteration, and the rest, run slot by slot
        if (k > 0) {
          const uint32_t ku = (uint32_t)k;
          time += (int32_t)(ku * d_time);
          instret += ku * (instret - a_instret);
          instrs += ku * (instrs - a_instrs);
          ihits += ku * (ihits - a_ihits);
          dhits += ku * (dhits - a_dhits);
          q += (int)k * L;
          skipped += (int)k * L;
        }
      }
      anchor_pc = (int32_t)upc;
      a_q = q + 1;
      a_time = time;
      a_instret = instret;
      a_instrs = instrs;
      a_ihits = ihits;
      a_dhits = dhits;
      dirty = false;
    }
  }

  // the DRAM store log, in order
  int32_t* dram = ptr<int32_t>(P, P_DRAM) + s * dram_words;
  const int n_log = min(log_count, store_log);
  for (int i = 0; i < n_log; ++i) dram[log_addr[i]] = log_data[i];
  log_addr[2 * store_log] = skipped;

  const int32_t peak = ptr<const int32_t>(P, P_STORE_PEAK)[s];
  ptr<int32_t>(P, O_TIME)[s] = time;
  ptr<uint8_t>(P, O_HALTED)[s] = halted;
  ptr<uint8_t>(P, O_WAITING)[s] = waiting;
  ptr<int32_t>(P, O_PC)[s] = pc;
  ptr<int32_t>(P, O_INSTRET)[s] = (int32_t)instret;
  ptr<int32_t>(P, O_IHITS)[s] = (int32_t)ihits;
  ptr<int32_t>(P, O_IMISSES)[s] = imisses;
  ptr<int32_t>(P, O_DHITS)[s] = (int32_t)dhits;
  ptr<int32_t>(P, O_DMISSES)[s] = dmisses;
  ptr<int32_t>(P, O_LAST_ROW)[s] = last_row;
  ptr<uint8_t>(P, O_LAST_WRITE)[s] = last_write;
  ptr<int32_t>(P, O_READS)[s] = reads;
  ptr<int32_t>(P, O_WRITES)[s] = writes;
  ptr<int32_t>(P, O_INSTRS)[s] = (int32_t)instrs;
  ptr<int32_t>(P, O_MMIO_LATE)[s] = mmio_late;
  ptr<int32_t>(P, O_STORE_PEAK)[s] = peak > log_count ? peak : log_count;
  ptr<int32_t>(P, P_OB_COUNT)[s] = ob_count;
}

__global__ void slot_scan_kernel(const Params P) {
  extern __shared__ uint4 sh[];
  const int s = blockIdx.x;
  if (P.p[P_LAUNCHES] != nullptr && s == 0 && threadIdx.x == 0) atomicAdd(ptr<int32_t>(P, P_LAUNCHES), 1);
  const int sw = P.n[I_SCRATCH_WORDS], pw = P.n[I_PROG_WORDS];
  const int isets = P.n[I_ISET_MASK] + 1, dsets = P.n[I_DSET_MASK] + 1;
  uint4* table = sh;
  int32_t* scratch = reinterpret_cast<int32_t*>(table + pw);
  int32_t* itags = scratch + sw;
  int32_t* dtags = itags + isets;
  int32_t* regs = dtags + dsets;
  for (int i = threadIdx.x; i < pw; i += blockDim.x)
    table[i] = predecode(ptr<const uint32_t>(P, P_PROG)[(size_t)s * pw + i], i,
                         P.n[I_LINE_SHIFT], P.n[I_ISET_MASK]);
  for (int i = threadIdx.x; i < sw; i += blockDim.x)
    scratch[i] = ptr<const int32_t>(P, P_SCRATCH)[(size_t)s * sw + i];
  for (int i = threadIdx.x; i < isets; i += blockDim.x)
    itags[i] = ptr<const int32_t>(P, P_ITAGS)[(size_t)s * isets + i];
  for (int i = threadIdx.x; i < dsets; i += blockDim.x)
    dtags[i] = ptr<const int32_t>(P, P_DTAGS)[(size_t)s * dsets + i];
  if (threadIdx.x < 32) regs[threadIdx.x] = ptr<const int32_t>(P, P_REGS)[s * 32 + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) run_segment(P, s, scratch, table, itags, dtags, regs);
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

// Lets the kernel take up to the current device's opt-in dynamic shared
// memory; call once per device before the first launch there (the wrapper
// does, under its lock, outside any capture).  Returns the CUDA error, 0 on
// success.
extern "C" int slot_scan_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slot_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  return (int)err;
}

// Launches one block per segment on ``stream``; returns cudaGetLastError()
// after the launch (0 on success), or -1 when the caller's argument counts
// differ from this build's.  ``ptrs`` holds N_PTRS device pointers and
// ``ints`` N_INTS integers, in the orders above.  Dynamic shared memory: 16
// bytes per program word (the decoded table) and 4 per scratch word, cache
// set and register — 30,848 bytes at the platform's sizes (past 48 KB only
// after slot_scan_prepare).
extern "C" int slot_scan_launch(void* const* ptrs, int n_ptrs, const int* ints,
                                int n_ints, int n_segments, void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS) return -1;
  Params P;
  for (int i = 0; i < N_PTRS; ++i) P.p[i] = ptrs[i];
  for (int i = 0; i < N_INTS; ++i) P.n[i] = ints[i];
  const size_t shmem = sizeof(uint4) * (size_t)P.n[I_PROG_WORDS] + sizeof(int32_t) *
      (size_t)(P.n[I_SCRATCH_WORDS] + P.n[I_ISET_MASK] + 1 + P.n[I_DSET_MASK] + 1 + 32);
  slot_scan_kernel<<<n_segments, 256, shmem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
