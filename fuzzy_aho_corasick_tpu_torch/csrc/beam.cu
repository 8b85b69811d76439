// The beam frontier for Hopper (sm_90a): beam_pool_thread_kernel and
// beam_pool_kernel (E = 1) and beam_sorted_kernel (E >= 2), each a count
// launch and a write launch around block_offsets_kernel, then
// beam_order_kernel.
//
// Replaces the JAX package's XLA device functions
// fuzzy_aho_corasick_tpu/ops/fuzzy.py::_fuzzy1_core / _fuzzy1_scan_kernel
// (:342-523, the E = 1 pool) and ::_expand + _dedup_compact +
// _fuzzy_scan_kernel (:57-340, the sorted E >= 2 beam): the per-start BFS of
// the reference (src/search.rs:418-1119) over the candidate starts of the
// engines the DP and many lanes decline. Plain torch versions:
// ops/fuzzy.py::_pool_chunk, ::_beam_chunk and ::order_emissions_torch;
// wrappers ops/fuzzy.py::pool_frontier, ::sorted_frontier and
// ::order_emissions; the tables: ops/fuzzy.py::beam_tables (BeamTables.k32).
//
// What it computes. A run of n starts against the dense automaton. Start s
// walks T rounds from the root (node 0, j = me = 0, no edit, penalty +0):
// each round pops every state of its frontier once, with the exact,
// substitution, swap, insertion and deletion pushes and every push guard of
// ops/fuzzy.py::_expand (candidate()), f32 in the oracle's order (__fadd_rn
// and friends; the library is built with -fmad=false). The root round takes
// the full edge width Df, later rounds the deepest non-root degree Dd. Its
// emissions are (state, output pattern) pairs at output nodes whose
// similarity ((len - pen) / len) * weight passes the slack threshold,
// returned as (s, me, pattern, counts) int64 [4, total] and the penalty f32
// [total] in the JAX order (chunk of nchunk starts, round, start, slot,
// output).
//   E = 1: the frontier is the 0-edit walk s0 (slot P, after every pool
//          slot) and an append-only pool of 1-edit walks (slots S0 + (r - 1)
//          Sd + column - 1, S0 = 2 Df + 2, Sd = 2 Dd + 2, P = S0 + (T - 1)
//          Sd): each round every pool walk takes its exact step with the
//          push-time ceiling, then s0 is expanded (its exact column is the
//          new s0, the rest spawn).
//   E >= 2: the round's candidates of the beam (at most B = 32 + 24 E
//          states) are sorted on (node, j << 16 | me, counts, the penalty's
//          total order), the first of each (node, j, me, counts) kept; its
//          rank is its slot. More than B kept overflows the start: it writes
//          no emission, its flag is set and the host oracle re-searches it.
//
// The pass, per run (ops/fuzzy.py::_frontier_kernels): the count phase
// writes each start's emissions over all its rounds into counts [n] (0 for
// an overflowed start) and adds the run's emissions, states expanded,
// rounds, overflowed starts, starts that went to the global scratch, rounds
// sorted in memory and starts handed on into stats; block_offsets scans the
// n counts; the host reads stats (the only wait); where the run emits, the
// write phase runs again only the starts whose count is not 0 and stages
// each start's emissions together at its offset, each with its round
// (start-major); then beam_order_kernel, a block per chunk, puts each
// chunk's segment in round order by a stable counting sort (the JAX order),
// writing the outputs.
//
// Design. A start's frontier never reads another's, so the JAX lockstep
// rounds become a loop that ends when the start's frontier empties, and a
// persistent grid takes the starts in turn from a work counter, in batches
// strided over the run (batch b holds starts b, b + NB, ..., NB = items /
// batch), so that neighbouring starts, whose costs go together, run on
// different warps, and sized so that every warp gets several.
// E = 1, a thread a start (beam_pool_thread_kernel): 32 starts a warp, the
// rounds in slot order one state at a time, the pool of up to
// THREAD_POOL_WALKS walks in shared memory (interleaved by thread). A start whose pool
// outgrows them is handed on (flagged, appended to a list) to the warp path
// (beam_pool_kernel), a warp a start from that list, the pool walks on its
// lanes (ballot compaction keeps slot order, so a warp scan places the
// emissions), up to POOL_CHIP_WALKS walks on chip and past them in the warp's region
// of the global scratch. E >= 2: a warp a start, SORT_WARPS starts a block,
// no block barrier: candidates are appended by ballot as 16-byte keys that
// carry every field ((node, j, me) and (counts, the penalty's order bits));
// a round of at most 64 sorts in registers (two keys a lane, a shuffle
// bitonic network) and is deduplicated by ballot; a larger round sorts in
// memory (a bitonic network whose comparators all put the lesser key first,
// __syncwarp between steps). A warp's keys live in shared memory up to
// SORT_CHIP_KEYS candidates beside its B beam states, and move to its region of the global
// scratch in a round with more. The kernels stage the automaton's tables
// (go, sb, et/ec, sim, out_count/out_list, ceil, pat_len, pat_weight) into
// shared memory once per persistent block with cp.async where they take up
// to TABLES_SMEM_MAX bytes and fit beside the workspace (tables_layout, u8
// ids only; the deep rounds read the full edge
// lists with stride Df), else read them from global memory; which, is a
// template argument, so the kernel parameters stay constant and their
// pointers take no registers.
//
// What bounds it on the H100. The bytes it must move: the starts read once,
// a symbol each, each emission's 36 bytes written once (0.0005-0.003 ms at
// phase 4j's shapes). Each round is a chain of dependent gathers (symbol,
// goto, edges, similarity, ceilings) and, at E >= 2, a sort: the time goes
// to the latency of those chains and to the instructions a round issues.
// A thread a start issues each instruction for up to 32 starts (a warp a
// start for one), with thousands of starts in flight an SM; the write phase
// runs only the starts that emit. PERF.md §6 holds the times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Threads per block of the pool kernels (a thread a start; a warp a start
// past the thread's walks), the sorted kernel (a warp a start) and the
// order kernel.
constexpr int POOL_THREADS = 256;
constexpr int POOL_WARPS = POOL_THREADS / 32;
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int ORDER_WARPS = 32;
// The most dynamic shared memory a block may opt in to on sm_90.
constexpr int SMEM_MAX = 232448;
// The order kernel's per-warp round histograms stay on chip up to this.
constexpr int ORDER_SMEM = 49152;
// Bytes a pool walk or a sort key takes.
constexpr int ENTRY_BYTES = 16;
// A round of at most this many candidates sorts in registers.
constexpr int WARP_SORT_KEYS = 64;
// Walks a thread of the pool's thread path keeps in shared memory (a start
// whose pool grows past them is handed to the warp path); walks a pool warp
// keeps there, and candidates a sorted warp keeps there beside its beam
// (past them a start's pool, or a round's keys, move to the warp's region of
// the global scratch).
constexpr int THREAD_POOL_WALKS = 8;
constexpr int POOL_CHIP_WALKS = 256;
constexpr int SORT_CHIP_KEYS = 128;
// The tables are staged into shared memory up to this many bytes.
constexpr int TABLES_SMEM_MAX = 1 << 16;
// The most starts a warp takes from the work counter at once.
constexpr int BATCH = 32;
// Columns of an expansion a thread of the pool's thread path evaluates at
// once, and pool walks a lane of its warp path steps in one pass:
// independent chains of gathers in flight.
constexpr int EXPAND_ILP = 2;
constexpr int STEP_ILP = 4;
// The stats' slots (int64): emissions, states expanded, rounds (the most of
// any start), overflowed starts, starts whose keys or pool went to the
// global scratch, rounds sorted in memory, starts the thread path handed to
// the warp path, the emissions of those starts, whether the count launch
// read the tables from shared memory (1) or global memory (0), and the work
// counters of the four launches (thread or warp path, count or write).
enum {
  ST_EM,
  ST_STATES,
  ST_ROUNDS,
  ST_OVER,
  ST_SPILL,
  ST_MEMSORT,
  ST_HANDED,
  ST_HANDED_EM,
  ST_CHIP,
  ST_CURSOR,
  ST_SLOTS = 16
};

typedef unsigned long long u64;

struct Tables {
  const void* ids;
  long long limit;
  const int* go;
  const uint8_t* sb;
  int N, C;
  const int* et_full;
  const int* ec_full;
  int Df;
  const int* et_deep;
  const int* ec_deep;
  int Dd;
  const float* sim;
  const int* out_count;
  const int* out_list;
  int MO;
  const float* pat_len;
  const float* pat_weight;
  int npat;
  const float* ceil;
  float max_pen, p_sub, p_ins, p_del, p_swap, floor_, slack;
  int E, T, B;
  // Byte offsets of each table in shared memory where they are staged
  // (tables_layout), and of the workspace after them.
  int o_go, o_sim, o_et, o_ec, o_oc, o_ceil, o_ol, o_pl, o_pw, o_sb, o_ws;
};

// The tables as a kernel reads them: the parameters' global pointers, or
// their copies in shared memory (the deep edge rows then read the full
// lists with stride Df).
struct Tab {
  const int* go;
  const uint8_t* sb;
  const int* et_full;
  const int* ec_full;
  const int* et_deep;
  const int* ec_deep;
  int ds;
  const float* sim;
  const int* out_count;
  const int* out_list;
  const float* pat_len;
  const float* pat_weight;
  const float* ceil;
};

// A staged emission: the start's index in the run, me, pattern, counts,
// penalty and round (24 bytes; ops/fuzzy.py::STAGED_FIELDS).
struct Em {
  int si, me, pat;
  unsigned counts;
  float pen;
  int round;
};

struct Run {
  const long long* starts;
  long long n;
  int write;
  int* counts;
  const int* offsets;
  Em* staged;
  long long total;
  // E >= 2: the overflowed starts; E = 1: the starts handed to the warp
  // path, whose indices the thread path appends to handed.
  uint8_t* flags;
  int* handed;
  u64* stats;
  // The walks or candidate keys a warp keeps on chip (Layout::chip).
  int chip;
  uint8_t* scratch;
  long long spill_bytes;
};

struct St {
  int node, j, me;
  unsigned counts;
  float pen;
};

// Per-state values every column of an expansion reads.
struct Ctx {
  St s;
  bool in_text, in_text2, can_edit, is_last;
  int sym_j, sym_j1, exact_next;
  float remaining;
};

// --- Sizes (ops/fuzzy.py::frontier_workspace, ::tables_bytes and
// ::tables_on_chip mirror them)

__host__ __device__ inline long long r16(long long b) { return (b + 15) / 16 * 16; }

long long pool_slots(int Df, int Dd, int T) {
  return (2ll * Df + 2) + (long long)(T - 1) * (2ll * Dd + 2);
}
long long sort_cap(int Df, int Dd, int B) {
  const long long root = 2ll * Df + 3, deep = (long long)B * (2ll * Dd + 3);
  return root > deep ? root : deep;
}

// Lays the staged tables out from offset 0, each from a 16-byte boundary,
// into t's offsets; returns their bytes (ops/fuzzy.py::tables_bytes).
long long tables_layout(Tables* t, int N, int C, int Df, int MO, int npat) {
  long long at = 0;
  int o[10];
  const long long bytes[10] = {4ll * N * C, 4ll * C * C, 4ll * N * Df, 4ll * N * Df, 4ll * N,
                               4ll * N, 4ll * N * MO, 4ll * npat, 4ll * npat, (long long)N * C};
  for (int i = 0; i < 10; ++i) {
    o[i] = (int)at;
    at += r16(bytes[i]);
  }
  if (t) {
    t->o_go = o[0], t->o_sim = o[1], t->o_et = o[2], t->o_ec = o[3], t->o_oc = o[4];
    t->o_ceil = o[5], t->o_ol = o[6], t->o_pl = o[7], t->o_pw = o[8], t->o_sb = o[9];
  }
  return at;
}

// A launch's layout: the warp path's warps a block (each a start at a
// time), the entries a warp keeps on chip (pool walks, or candidate keys
// beside a beam of B), the block's on-chip workspace (beside any tables),
// the global scratch a warp needs (0: none); at E = 1 also the walks a
// thread keeps on chip and the thread path's on-chip workspace a block; the
// tables' bytes, and whether they are staged into shared memory (u8 ids,
// up to TABLES_SMEM_MAX bytes, beside each of the launch's workspaces).
struct Layout {
  long long units, chip, ws, spill, light_chip, light_ws, tables, on_chip;
};
Layout layout_of(int E, int Df, int Dd, int T, int N, int C, int MO, int npat, int sym_bytes,
                 Tables* t) {
  Layout L;
  if (E == 1) {
    const long long P = pool_slots(Df, Dd, T);
    L.units = POOL_WARPS;
    L.chip = POOL_CHIP_WALKS < P ? POOL_CHIP_WALKS : P;
    L.ws = L.units * ENTRY_BYTES * L.chip;
    L.spill = P > L.chip ? ENTRY_BYTES * P : 0;
    L.light_chip = THREAD_POOL_WALKS;
    L.light_ws = (long long)POOL_THREADS * ENTRY_BYTES * THREAD_POOL_WALKS;
  } else {
    const int B = 32 + 24 * E;
    const long long cap = sort_cap(Df, Dd, B);
    L.units = SORT_WARPS;
    L.chip = SORT_CHIP_KEYS < cap ? SORT_CHIP_KEYS : cap;
    L.ws = L.units * ENTRY_BYTES * (B + L.chip);
    L.spill = cap > L.chip ? ENTRY_BYTES * cap : 0;
    L.light_chip = L.light_ws = 0;
  }
  L.tables = tables_layout(t, N, C, Df, MO, npat);
  L.on_chip = sym_bytes == 1 && L.tables <= TABLES_SMEM_MAX &&
              L.tables + (L.ws > L.light_ws ? L.ws : L.light_ws) <= SMEM_MAX;
  return L;
}

// --- Tables on chip ------------------------------------------------------------

// Copies bytes from global memory into shared memory at dst with cp.async,
// 4 bytes a copy (the last one zero-filled past the end).
__device__ __forceinline__ void stage(uint8_t* dst, const void* src, long long bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  for (long long i = 4ll * threadIdx.x; i < bytes; i += 4ll * blockDim.x) {
    const int sz = bytes - i < 4 ? (int)(bytes - i) : 4;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + (unsigned)i),
                 "l"(g + (size_t)i), "r"(sz)
                 : "memory");
  }
}

// Stages the tables into shared memory at their offsets; the block waits
// for the copies.
__device__ __forceinline__ void stage_tables(const Tables& t, uint8_t* smem) {
  const long long N = t.N, C = t.C;
  stage(smem + t.o_go, t.go, 4 * N * C);
  stage(smem + t.o_sim, t.sim, 4 * C * C);
  stage(smem + t.o_et, t.et_full, 4 * N * t.Df);
  stage(smem + t.o_ec, t.ec_full, 4 * N * t.Df);
  stage(smem + t.o_oc, t.out_count, 4 * N);
  stage(smem + t.o_ceil, t.ceil, 4 * N);
  stage(smem + t.o_ol, t.out_list, 4 * N * t.MO);
  stage(smem + t.o_pl, t.pat_len, 4ll * t.npat);
  stage(smem + t.o_pw, t.pat_weight, 4ll * t.npat);
  stage(smem + t.o_sb, t.sb, N * C);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The kernel's view of the tables (CHIP: staged into smem first).
template <bool CHIP>
__device__ __forceinline__ Tab tab_of(const Tables& t, uint8_t* smem) {
  if (CHIP) {
    const int* et = reinterpret_cast<const int*>(smem + t.o_et);
    const int* ec = reinterpret_cast<const int*>(smem + t.o_ec);
    return Tab{reinterpret_cast<const int*>(smem + t.o_go), smem + t.o_sb, et, ec, et, ec, t.Df,
               reinterpret_cast<const float*>(smem + t.o_sim),
               reinterpret_cast<const int*>(smem + t.o_oc),
               reinterpret_cast<const int*>(smem + t.o_ol),
               reinterpret_cast<const float*>(smem + t.o_pl),
               reinterpret_cast<const float*>(smem + t.o_pw),
               reinterpret_cast<const float*>(smem + t.o_ceil)};
  }
  return Tab{t.go, t.sb, t.et_full, t.ec_full, t.et_deep, t.ec_deep, t.Dd, t.sim, t.out_count,
             t.out_list, t.pat_len, t.pat_weight, t.ceil};
}

// --- One BFS pop ---------------------------------------------------------------

template <typename SymT>
__device__ __forceinline__ int sym_at(const Tables& t, long long pos) {
  return pos < t.limit ? (int)__ldg(static_cast<const SymT*>(t.ids) + pos) : 0;
}

__device__ __forceinline__ int goto_of(const Tables& t, const Tab& tb, int node, int sym) {
  return tb.go[node * t.C + sym];
}

__device__ __forceinline__ bool sb_of(const Tables& t, const Tab& tb, int node, int sym) {
  return tb.sb[node * t.C + sym] != 0;
}

template <typename SymT>
__device__ __forceinline__ Ctx make_ctx(const Tables& t, const Tab& tb, long long pos0,
                                        const St& s) {
  Ctx c;
  c.s = s;
  const int edits = (int)(s.counts & 0xff) + (int)((s.counts >> 8) & 0xff) +
                    (int)((s.counts >> 16) & 0xff) + (int)((s.counts >> 24) & 0xff);
  c.can_edit = edits < t.E;
  c.is_last = c.can_edit && edits + 1 >= t.E;
  const long long pos = pos0 + s.j;
  c.in_text = pos < t.limit;
  c.in_text2 = pos + 1 < t.limit;
  c.sym_j = c.in_text ? sym_at<SymT>(t, pos) : 0;
  c.sym_j1 = c.in_text2 ? sym_at<SymT>(t, pos + 1) : 0;
  c.remaining = __fsub_rn(t.max_pen, s.pen);
  // Exact transition (src/search.rs:776-798); class 0 has no edges.
  c.exact_next = c.in_text ? goto_of(t, tb, s.node, c.sym_j) : -1;
  return c;
}

// Column col of the expansion of c over edge width D, edge rows of stride ds
// (ops/fuzzy.py::_expand: exact, D substitutions, swap, insertion, D
// deletions): the candidate, node -1 where a push guard fails.
__device__ __forceinline__ St candidate(const Tables& t, const Tab& tb, const Ctx& c, int col,
                                        int D, const int* et, const int* ec, int ds) {
  const St& s = c.s;
  St o{-1, s.j + 1, s.j + 1, s.counts, s.pen};
  bool valid = false;
  int cn = -1;
  if (col == 0) {
    valid = c.in_text;
    cn = c.exact_next;
  } else if (col <= D) {
    // Substitution over edge col - 1 (src/search.rs:803-874).
    const int tn = et[s.node * ds + col - 1];
    cn = tn;
    if (tn >= 0 && c.in_text && c.can_edit && tn != c.exact_next) {
      const int cls = ec[s.node * ds + col - 1];
      const float sm = tb.sim[cls * t.C + c.sym_j];
      const float pnl = __fmul_rn(t.p_sub, __fsub_rn(1.0f, sm));
      valid = !(sm < t.floor_) && !(pnl > c.remaining);
      // Last-edit dead-end filter (src/search.rs:839-847).
      if (valid && c.is_last)
        valid = tb.out_count[tn] > 0 || (c.in_text2 && sb_of(t, tb, tn, c.sym_j1));
      o.counts = s.counts + 0x10000u;
      o.pen = __fadd_rn(s.pen, pnl);
    }
  } else if (col == D + 1) {
    // Swap (src/search.rs:935-989).
    const int mid = c.in_text2 ? goto_of(t, tb, s.node, c.sym_j1) : -1;
    cn = mid >= 0 ? goto_of(t, tb, mid, c.sym_j) : -1;
    valid = c.in_text2 && t.p_swap <= c.remaining && c.can_edit && cn >= 0;
    o.j = o.me = s.j + 2;
    o.counts = s.counts + 0x1000000u;
    o.pen = __fadd_rn(s.pen, t.p_swap);
  } else if (col == D + 2) {
    // Insertion (src/search.rs:994-1029).
    cn = s.node;
    valid = c.in_text && (s.me != 0 || s.j != 0) && t.p_ins <= c.remaining && c.can_edit &&
            !(c.is_last && tb.out_count[s.node] == 0 &&
              !(c.in_text2 && sb_of(t, tb, s.node, c.sym_j1)));
    o.me = s.me;
    o.counts = s.counts + 1u;
    o.pen = __fadd_rn(s.pen, t.p_ins);
  } else {
    // Deletion over edge col - D - 3 (src/search.rs:1035-1089).
    const int tn = et[s.node * ds + col - D - 3];
    cn = tn;
    valid = tn >= 0 && c.can_edit && t.p_del <= c.remaining &&
            !(c.is_last && tb.out_count[tn] == 0 && !(c.in_text && sb_of(t, tb, tn, c.sym_j)));
    o.j = s.j;
    o.me = s.me;
    o.counts = s.counts + 0x100u;
    o.pen = __fadd_rn(s.pen, t.p_del);
  }
  // Per-node prune ceiling at pop time (src/search.rs:637-642).
  if (valid && cn >= 0 && !(o.pen > tb.ceil[cn])) o.node = cn;
  return o;
}

// Whether output column o of node passes the slack threshold, and its
// pattern (ops/fuzzy.py::_emit).
__device__ __forceinline__ int emitted(const Tables& t, const Tab& tb, int node, int o, float pen) {
  const int p = tb.out_list[node * t.MO + o];
  if (p < 0) return -1;
  const float total = tb.pat_len[p];
  const float sim = __fmul_rn(__fdiv_rn(__fsub_rn(total, pen), total), tb.pat_weight[p]);
  return sim >= t.slack ? p : -1;
}

__device__ __forceinline__ int emit_count(const Tables& t, const Tab& tb, const St& s) {
  if (s.node < 0 || tb.out_count[s.node] <= 0) return 0;
  int k = 0;
  for (int o = 0; o < t.MO; ++o) k += emitted(t, tb, s.node, o, s.pen) >= 0;
  return k;
}

// Stages the emissions of state s of start si in round rd from index at.
__device__ __forceinline__ void emit_write(const Tables& t, const Tab& tb, const Run& r,
                                           long long at, long long si, const St& s, int rd) {
  if (s.node < 0 || tb.out_count[s.node] <= 0) return;
  for (int o = 0; o < t.MO; ++o) {
    const int p = emitted(t, tb, s.node, o, s.pen);
    if (p < 0) continue;
    r.staged[at++] = Em{(int)si, s.me, p, s.counts, s.pen, rd};
  }
}

// --- Warp helpers -------------------------------------------------------------

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += x;
  }
  return v;
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
  return v;
}

// A warp's queue over a launch's items (the run's starts, or the handed-off
// list): batch b of the launch's work counter holds items b, b + NB, ..., b
// + (bs - 1) NB (NB = ceil(items / bs)), so that neighbouring starts, whose
// costs go together, run on different warps. Lane l of the batch holds its
// item's start in `mine` where it runs in this launch (the write launch
// skips the starts whose count is 0 and those flagged in skip), -1 else.
struct Queue {
  unsigned avail;
  long long mine;
  bool done;
};

// Loads the warp's next batch; the whole warp calls it.
__device__ __forceinline__ void refill(Queue& q, const Run& r, u64* cursor, long long items,
                                       const int* list, int bs, const uint8_t* skip) {
  const int lane = threadIdx.x & 31;
  const long long nb = (items + bs - 1) / bs;
  u64 b = 0;
  if (lane == 0) b = atomicAdd(cursor, 1ull);
  b = __shfl_sync(FULL, b, 0);
  if ((long long)b >= nb) {
    q.done = true;
    q.avail = 0;
    q.mine = -1;
    return;
  }
  const long long it = (long long)b + lane * nb;
  long long s = -1;
  if (lane < bs && it < items) s = list ? list[it] : it;
  const bool ok = s >= 0 && (!r.write || r.counts[s] != 0) && (skip == nullptr || !skip[s]);
  q.mine = ok ? s : -1;
  q.avail = __ballot_sync(FULL, ok);
}

// The warp's next start (every lane), or -1 when the launch has none left.
__device__ __forceinline__ long long take(Queue& q, const Run& r, u64* cursor, long long items,
                                          const int* list, int bs) {
  while (!q.avail && !q.done) refill(q, r, cursor, items, list, bs, nullptr);
  if (!q.avail) return -1;
  const int bit = __ffs(q.avail) - 1;
  q.avail &= q.avail - 1;
  return __shfl_sync(FULL, q.mine, bit);
}

// Starts a warp takes at once where it takes them one by one: enough
// batches that every warp of the grid gets about 8.
__device__ __forceinline__ int batch_of(long long items, int warps) {
  const long long bs = items / ((long long)gridDim.x * warps * 8);
  return bs < 1 ? 1 : bs > BATCH ? BATCH : (int)bs;
}

// --- E = 1 ---------------------------------------------------------------------------

// A pool walk as 16 bytes: node, j << 16 | me, counts, penalty.
__device__ __forceinline__ int4 pack(const St& s) {
  return make_int4(s.node, (s.j << 16) | s.me, (int)s.counts, __float_as_int(s.pen));
}
__device__ __forceinline__ St unpack(int4 e) {
  return St{e.x, e.y >> 16, e.y & 0xffff, (unsigned)e.z, __int_as_float(e.w)};
}

// The thread path: a thread a start, its pool of up to THREAD_POOL_WALKS walks in
// shared memory (walk k of thread x at k * POOL_THREADS + x), every round in
// slot order: the pool's exact steps (a walk that stays emits), the 0-edit
// walk's expansion (its exact column the next s0, the others spawn), then
// the spawns' and s0's emissions. A start whose pool would pass
// THREAD_POOL_WALKS walks is handed to the warp path (count launch: flagged and appended to
// r.handed; the write launch skips it).
template <typename SymT, bool CHIP>
__global__ void __launch_bounds__(POOL_THREADS, 4) beam_pool_thread_kernel(const Tables t,
                                                                        const Run r) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (CHIP) stage_tables(t, smem);
  if (CHIP && !r.write && blockIdx.x == 0 && threadIdx.x == 0) r.stats[ST_CHIP] = 1;
  const Tab tb = tab_of<CHIP>(t, smem);
  const int lane = threadIdx.x & 31;
  int4* const pool = reinterpret_cast<int4*>(smem + (CHIP ? t.o_ws : 0)) + threadIdx.x;
  Queue q{0u, -1, false};
  u64 n_em = 0, n_states = 0;
  int n_rounds = 0;
  for (;;) {
    refill(q, r, r.stats + ST_CURSOR + r.write, r.n, nullptr, BATCH, r.write ? r.flags : nullptr);
    if (q.done) break;
    const long long s = q.mine;
    if (s < 0) continue;
    const long long pos0 = r.starts[s];
    const long long obase = r.write ? r.offsets[s] : 0;
    int n = 0, rd = 0, s0n = 0, s0j = 0, em = 0, states = 0;
    bool handed = false;
    for (;;) {
      // 1) every pool walk takes its exact transition, with the push-time
      //    ceiling (src/search.rs:637-642); the dead leave, the order stays;
      //    a walk that stays emits.
      int keep = 0;
      for (int k = 0; k < n; ++k) {
        St w = unpack(pool[k * POOL_THREADS]);
        const long long pos = pos0 + w.j;
        int nxt = pos < t.limit ? goto_of(t, tb, w.node, sym_at<SymT>(t, pos)) : -1;
        if (nxt < 0 || w.pen > tb.ceil[nxt]) continue;
        w.node = nxt;
        w.j = w.me = w.j + 1;
        pool[keep++ * POOL_THREADS] = pack(w);
        const int kw = emit_count(t, tb, w);
        if (r.write && kw) emit_write(t, tb, r, obase + em, s, w, rd);
        em += kw;
      }
      n = keep;
      const int n_old = n;
      // 2) the 0-edit walk (the root at full width in round 0).
      if (s0n >= 0) {
        const bool root = rd == 0;
        const int D = root ? t.Df : t.Dd;
        const Ctx c = make_ctx<SymT>(t, tb, pos0, St{s0n, s0j, s0j, 0u, 0.f});
        int nn = -1, nj = 0;
        for (int c0 = 0; c0 < 2 * D + 3 && !handed; c0 += EXPAND_ILP) {
          // EXPAND_ILP columns' chains of gathers in flight, then their
          // pushes in column order.
          St o[EXPAND_ILP];
#pragma unroll
          for (int u = 0; u < EXPAND_ILP; ++u) {
            const int col = c0 + u;
            o[u] = St{-1, 0, 0, 0u, 0.f};
            if (col < 2 * D + 3)
              o[u] = root ? candidate(t, tb, c, col, D, tb.et_full, tb.ec_full, t.Df)
                          : candidate(t, tb, c, col, D, tb.et_deep, tb.ec_deep, tb.ds);
          }
#pragma unroll
          for (int u = 0; u < EXPAND_ILP; ++u) {
            if (c0 + u == 0) {
              nn = o[u].node;
              nj = o[u].j;
            } else if (o[u].node >= 0 && !handed) {
              if (n == THREAD_POOL_WALKS)
                handed = true;
              else
                pool[n++ * POOL_THREADS] = pack(o[u]);
            }
          }
        }
        if (handed) break;
        s0n = nn;
        s0j = nj;
        ++states;
      }
      // 3) the spawns' emissions in slot order, then s0's (slot P).
      for (int k = n_old; k < n; ++k) {
        const St w = unpack(pool[k * POOL_THREADS]);
        const int kw = emit_count(t, tb, w);
        if (r.write && kw) emit_write(t, tb, r, obase + em, s, w, rd);
        em += kw;
      }
      const St z{s0n, s0j, s0j, 0u, 0.f};
      const int k0 = emit_count(t, tb, z);
      if (r.write && k0) emit_write(t, tb, r, obase + em, s, z, rd);
      em += k0;
      // 4) the start ends after T rounds or when its frontier is empty.
      if (++rd >= t.T || (n == 0 && s0n < 0)) break;
    }
    if (!r.write) {
      r.flags[s] = handed;
      if (handed) {
        r.handed[atomicAdd(r.stats + ST_HANDED, 1ull)] = (int)s;
      } else {
        r.counts[s] = em;
        n_em += (u64)em;
        n_states += (u64)states;
        n_rounds = rd > n_rounds ? rd : n_rounds;
      }
    }
  }
  if (!r.write) {
    n_em = warp_sum(n_em);
    n_states = warp_sum(n_states);
    n_rounds = __reduce_max_sync(FULL, n_rounds);
    if (lane == 0) {
      atomicAdd(r.stats + ST_EM, n_em);
      atomicAdd(r.stats + ST_STATES, n_states);
      atomicMax(r.stats + ST_ROUNDS, (u64)n_rounds);
    }
  }
}

// The warp path: a warp a start from the handed-off list, the pool walks on
// its lanes (ballot compaction keeps slot order, so a warp scan places the
// emissions), up to chip walks in shared memory, past them in the warp's
// region of the global scratch.
template <typename SymT, bool CHIP>
__global__ void __launch_bounds__(POOL_THREADS, 2) beam_pool_kernel(const Tables t, const Run r) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long items = (long long)r.stats[ST_HANDED];
  if (items == 0) return;  // the thread path handed nothing on
  if (CHIP) stage_tables(t, smem);
  const Tab tb = tab_of<CHIP>(t, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int4* const chip = reinterpret_cast<int4*>(smem + (CHIP ? t.o_ws : 0)) + warp * r.chip;
  int4* const spill =
      r.scratch ? reinterpret_cast<int4*>(
                      r.scratch + ((long long)blockIdx.x * POOL_WARPS + warp) * r.spill_bytes)
                : nullptr;
  const int bs = batch_of(items, POOL_WARPS);
  u64* const cursor = r.stats + ST_CURSOR + 2 + r.write;
  Queue q{0u, -1, false};
  u64 n_em = 0, n_states = 0, n_spill = 0;
  int n_rounds = 0;
  for (;;) {
    const long long s = take(q, r, cursor, items, r.handed, bs);
    if (s < 0) break;
    const long long pos0 = r.starts[s];
    const long long obase = r.write ? r.offsets[s] : 0;
    int n = 0, rd = 0, s0n = 0, s0j = 0, em = 0;
    bool spilled = false;
    int4* pool = chip;
    for (;;) {
      // 1) the pool's exact steps, STEP_ILP walks a lane a pass (their
      //    chains of gathers in flight together); a walk that stays emits.
      int keep = 0, done = 0;
      for (int i0 = 0; i0 < n; i0 += 32 * STEP_ILP) {
        St w[STEP_ILP];
        int k[STEP_ILP];
#pragma unroll
        for (int u = 0; u < STEP_ILP; ++u) {
          const int i = i0 + u * 32 + lane;
          w[u] = St{-1, 0, 0, 0u, 0.f};
          if (i < n) w[u] = unpack(pool[i]);
        }
#pragma unroll
        for (int u = 0; u < STEP_ILP; ++u) {
          if (w[u].node >= 0) {
            const long long pos = pos0 + w[u].j;
            int nxt = pos < t.limit ? goto_of(t, tb, w[u].node, sym_at<SymT>(t, pos)) : -1;
            if (nxt >= 0 && w[u].pen > tb.ceil[nxt]) nxt = -1;
            w[u].node = nxt;
            w[u].j = w[u].me = w[u].j + 1;
          }
          k[u] = emit_count(t, tb, w[u]);
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < STEP_ILP; ++u) {
          const unsigned m = __ballot_sync(FULL, w[u].node >= 0);
          if (w[u].node >= 0) pool[keep + __popc(m & lt)] = pack(w[u]);
          keep += __popc(m);
          if (__any_sync(FULL, k[u])) {
            const int incl = warp_incl_scan(k[u]);
            if (r.write && k[u])
              emit_write(t, tb, r, obase + em + done + incl - k[u], s, w[u], rd);
            done += __shfl_sync(FULL, incl, 31);
          }
        }
        __syncwarp();
      }
      n = keep;
      em += done;
      const int n_old = n;
      // 2) the 0-edit walk (the root at full width in round 0).
      if (s0n >= 0) {
        const bool root = rd == 0;
        const int D = root ? t.Df : t.Dd;
        const Ctx c = make_ctx<SymT>(t, tb, pos0, St{s0n, s0j, s0j, 0u, 0.f});
        int nn = -1, nj = 0;
        for (int c0 = 0; c0 < 2 * D + 3; c0 += 32) {
          const int col = c0 + lane;
          St o{-1, 0, 0, 0u, 0.f};
          if (col < 2 * D + 3)
            o = root ? candidate(t, tb, c, col, D, tb.et_full, tb.ec_full, t.Df)
                     : candidate(t, tb, c, col, D, tb.et_deep, tb.ec_deep, tb.ds);
          if (c0 == 0) {
            nn = __shfl_sync(FULL, o.node, 0);
            nj = __shfl_sync(FULL, o.j, 0);
          }
          const bool spawn = col >= 1 && o.node >= 0;
          const unsigned m = __ballot_sync(FULL, spawn);
          if (!spilled && n + __popc(m) > r.chip) {
            // Past the walks on chip: the pool moves to the global scratch.
            for (int j = lane; j < n; j += 32) spill[j] = pool[j];
            __syncwarp();
            pool = spill;
            spilled = true;
          }
          if (spawn) pool[n + __popc(m & lt)] = pack(o);
          n += __popc(m);
        }
        s0n = nn;
        s0j = nj;
        n_states += lane == 0;
        __syncwarp();
      }
      // 3) the spawns' emissions in slot order, then s0's (slot P).
      int done3 = 0;
      for (int i0 = n_old; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        St w{-1, 0, 0, 0u, 0.f};
        if (i < n) w = unpack(pool[i]);
        const int k = emit_count(t, tb, w);
        if (!__any_sync(FULL, k)) continue;
        const int incl = warp_incl_scan(k);
        if (r.write && k) emit_write(t, tb, r, obase + em + done3 + incl - k, s, w, rd);
        done3 += __shfl_sync(FULL, incl, 31);
      }
      const St z{s0n, s0j, s0j, 0u, 0.f};
      const int k0 = emit_count(t, tb, z);
      if (r.write && k0 && lane == 0) emit_write(t, tb, r, obase + em + done3, s, z, rd);
      em += done3 + k0;
      __syncwarp();
      // 4) the start ends after T rounds or when its frontier is empty.
      if (++rd >= t.T || (n == 0 && s0n < 0)) break;
    }
    if (!r.write && lane == 0) {
      r.counts[s] = em;
      n_em += (u64)em;
      n_rounds = rd > n_rounds ? rd : n_rounds;
      n_spill += spilled;
    }
  }
  if (!r.write && lane == 0) {
    atomicAdd(r.stats + ST_EM, n_em);
    atomicAdd(r.stats + ST_HANDED_EM, n_em);
    atomicAdd(r.stats + ST_STATES, n_states);
    atomicMax(r.stats + ST_ROUNDS, (u64)n_rounds);
    atomicAdd(r.stats + ST_SPILL, n_spill);
  }
}

// --- E >= 2: a warp per start ------------------------------------------------------

// The penalty's total order (-0.0 before +0.0) as unsigned bits, and back.
__device__ __forceinline__ unsigned pen_key(float pen) {
  const unsigned b = __float_as_uint(pen);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float pen_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ u64 key_hi(const St& s) {
  return ((u64)(unsigned)s.node << 32) | ((unsigned)s.j << 16) | (unsigned)s.me;
}
__device__ __forceinline__ u64 key_lo(const St& s) {
  return ((u64)s.counts << 32) | pen_key(s.pen);
}
__device__ __forceinline__ St decode(u64 hi, u64 lo) {
  return St{(int)(hi >> 32), (int)((hi >> 16) & 0xffff), (int)(hi & 0xffff),
            (unsigned)(lo >> 32), pen_of((unsigned)lo)};
}

__device__ __forceinline__ bool key_less(u64 ah, u64 al, u64 bh, u64 bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Whether key (h, l) starts a new (node, j, me, counts) after (ph, pl).
__device__ __forceinline__ bool key_new(u64 h, u64 l, u64 ph, u64 pl) {
  return h != ph || (l >> 32) != (pl >> 32);
}

// One compare-exchange step of the register network: element i (of 64,
// lane + 32 e) against element i ^ j in lane ^ j, within a bitonic merge of
// size k.
__device__ __forceinline__ void cmpx(u64& h, u64& l, int i, int j, int k) {
  const u64 ph = __shfl_xor_sync(FULL, h, j), pl = __shfl_xor_sync(FULL, l, j);
  const bool up = (i & k) == 0, low = (i & j) == 0;
  if (low == up ? key_less(ph, pl, h, l) : key_less(h, l, ph, pl)) {
    h = ph;
    l = pl;
  }
}

// The m <= 64 candidates (kh, kl) sorted in registers (two a lane, the keys
// past m +inf) and deduplicated by ballot: the first of each (node, j, me,
// counts) is kept at its rank in (bh, bl) up to B; returns how many are kept.
__device__ int sort_dedup_small(const u64* kh, const u64* kl, int m, u64* bh, u64* bl, int B) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  u64 h0 = lane < m ? kh[lane] : ~0ull, l0 = lane < m ? kl[lane] : ~0ull;
  u64 h1 = lane + 32 < m ? kh[lane + 32] : ~0ull, l1 = lane + 32 < m ? kl[lane + 32] : ~0ull;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {
        if (key_less(h1, l1, h0, l0)) {
          const u64 th = h0, tl = l0;
          h0 = h1;
          l0 = l1;
          h1 = th;
          l1 = tl;
        }
      } else {
        cmpx(h0, l0, lane, j, k);
        cmpx(h1, l1, lane + 32, j, k);
      }
    }
  }
  // The key before element lane (e = 0) and lane + 32 (e = 1).
  const u64 ph0 = __shfl_up_sync(FULL, h0, 1), pl0 = __shfl_up_sync(FULL, l0, 1);
  u64 ph1 = __shfl_up_sync(FULL, h1, 1), pl1 = __shfl_up_sync(FULL, l1, 1);
  const u64 th = __shfl_sync(FULL, h0, 31), tl = __shfl_sync(FULL, l0, 31);
  if (lane == 0) {
    ph1 = th;
    pl1 = tl;
  }
  const bool f0 = lane < m && (lane == 0 || key_new(h0, l0, ph0, pl0));
  const bool f1 = lane + 32 < m && key_new(h1, l1, ph1, pl1);
  const unsigned m0 = __ballot_sync(FULL, f0), m1 = __ballot_sync(FULL, f1);
  const int r0 = __popc(m0 & lt), r1 = __popc(m0) + __popc(m1 & lt);
  if (f0 && r0 < B) {
    bh[r0] = h0;
    bl[r0] = l0;
  }
  if (f1 && r1 < B) {
    bh[r1] = h1;
    bl[r1] = l1;
  }
  return __popc(m0) + __popc(m1);
}

__device__ __forceinline__ void cmp_swap(u64* hi, u64* lo, int a, int b) {
  const u64 ha = hi[a], hb = hi[b], la = lo[a], lb = lo[b];
  if (key_less(hb, lb, ha, la)) {
    hi[a] = hb;
    hi[b] = ha;
    lo[a] = lb;
    lo[b] = la;
  }
}

// Ascending sort of the m keys (hi, lo) in memory by the warp: a bitonic
// network of the next power of two whose every comparator puts the lesser
// key at the lower index (the first step of each merge compares mirrored
// pairs), so the keys past m act as +inf and their comparators are skipped.
__device__ void warp_sort(u64* hi, u64* lo, int m) {
  const int lane = threadIdx.x & 31;
  int np2 = 1;
  while (np2 < m) np2 <<= 1;
  const int pairs = np2 >> 1;
  for (int k = 2; k <= np2; k <<= 1) {
    const int half = k >> 1;
    for (int i = lane; i < pairs; i += 32) {
      const int blk = i / half, off = i - blk * half;
      const int a = blk * k + off, b = blk * k + k - 1 - off;
      if (b < m) cmp_swap(hi, lo, a, b);
    }
    __syncwarp();
    for (int j = half >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < pairs; i += 32) {
        const int a = 2 * j * (i / j) + i % j;
        if (a + j < m) cmp_swap(hi, lo, a, a + j);
      }
      __syncwarp();
    }
  }
}

// The first of each (node, j, me, counts) of the m sorted keys, kept at its
// rank in (bh, bl) up to B; returns how many are kept.
__device__ int dedup(const u64* hi, const u64* lo, int m, u64* bh, u64* bl, int B) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int kept = 0;
  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane;
    const bool f = i < m && (i == 0 || key_new(hi[i], lo[i], hi[i - 1], lo[i - 1]));
    const unsigned mk = __ballot_sync(FULL, f);
    const int rank = kept + __popc(mk & lt);
    if (f && rank < B) {
      bh[rank] = hi[i];
      bl[rank] = lo[i];
    }
    kept += __popc(mk);
  }
  return kept;
}

template <typename SymT, bool CHIP>
__global__ void __launch_bounds__(SORT_THREADS, 3)
    beam_sorted_kernel(const Tables t, const Run r, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (CHIP) stage_tables(t, smem);
  if (CHIP && !r.write && blockIdx.x == 0 && threadIdx.x == 0) r.stats[ST_CHIP] = 1;
  const Tab tb = tab_of<CHIP>(t, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int B = t.B;
  // The warp's beam (B keys) and its candidates on chip (chip keys), hi
  // words then lo words; its region of the global scratch (cap keys).
  u64* const bh = reinterpret_cast<u64*>(smem + (CHIP ? t.o_ws : 0)) + 2 * warp * (B + r.chip);
  u64* const bl = bh + B;
  u64* const ch = bl + B;
  u64* const cl = ch + r.chip;
  u64* const gh = r.scratch ? reinterpret_cast<u64*>(
                                  r.scratch + ((long long)blockIdx.x * SORT_WARPS + warp) *
                                                  r.spill_bytes)
                            : nullptr;
  u64* const gl = gh ? gh + cap : nullptr;
  Queue q{0u, -1, false};
  const int bs = batch_of(r.n, SORT_WARPS);
  u64 n_states = 0, n_em = 0, n_over = 0, n_spill = 0, n_mem = 0;
  int n_rounds = 0;
  for (;;) {
    const long long s = take(q, r, r.stats + ST_CURSOR + r.write, r.n, nullptr, bs);
    if (s < 0) break;
    const long long pos0 = r.starts[s];
    const long long obase = r.write ? r.offsets[s] : 0;
    if (lane == 0) {
      const St root{0, 0, 0, 0u, 0.f};
      bh[0] = key_hi(root);
      bl[0] = key_lo(root);
    }
    __syncwarp();
    int nb = 1, rd = 0;
    bool over = false, spilled = false;
    long long em = 0;
    for (; rd < t.T && nb > 0; ++rd) {
      // Expansion: a lane per (state, column); the live candidates are
      // appended by ballot (the sort orders them).
      const bool root = rd == 0;
      const int D = root ? t.Df : t.Dd;
      const int* et = root ? tb.et_full : tb.et_deep;
      const int* ec = root ? tb.ec_full : tb.ec_deep;
      const int ds = root ? t.Df : tb.ds;
      const int W = 2 * D + 3;
      n_states += nb;
      u64 *kh = ch, *kl = cl;
      int kcap = r.chip, m = 0;
      // The lane's (state, column), advanced by 32 items a pass.
      const int step_b = 32 / W, step_c = 32 - step_b * W;
      int b = lane / W, col = lane - b * W;
      for (int i0 = 0; i0 < nb * W; i0 += 32) {
        St o{-1, 0, 0, 0u, 0.f};
        if (b < nb)
          o = candidate(t, tb, make_ctx<SymT>(t, tb, pos0, decode(bh[b], bl[b])), col, D, et, ec,
                        ds);
        b += step_b;
        col += step_c;
        if (col >= W) {
          col -= W;
          ++b;
        }
        const bool live = o.node >= 0;
        const unsigned mk = __ballot_sync(FULL, live);
        const int k = __popc(mk);
        if (m + k > kcap) {
          // Past the keys on chip: this round's go to the global scratch.
          for (int j = lane; j < m; j += 32) {
            gh[j] = kh[j];
            gl[j] = kl[j];
          }
          __syncwarp();
          kh = gh;
          kl = gl;
          kcap = cap;
          spilled = true;
        }
        if (live) {
          const int at = m + __popc(mk & lt);
          kh[at] = key_hi(o);
          kl[at] = key_lo(o);
        }
        m += k;
      }
      __syncwarp();
      int kept;
      if (m <= WARP_SORT_KEYS) {
        kept = sort_dedup_small(kh, kl, m, bh, bl, B);
      } else {
        n_mem += lane == 0;
        warp_sort(kh, kl, m);
        kept = dedup(kh, kl, m, bh, bl, B);
      }
      if (kept > B) {
        over = true;
        ++rd;
        break;
      }
      nb = kept;
      __syncwarp();
      // The round's emissions, slot by slot.
      int done = 0;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int bi = b0 + lane;
        St st{-1, 0, 0, 0u, 0.f};
        if (bi < nb) st = decode(bh[bi], bl[bi]);
        const int k = emit_count(t, tb, st);
        if (!__any_sync(FULL, k)) continue;
        const int incl = warp_incl_scan(k);
        if (r.write && k) emit_write(t, tb, r, obase + em + done + incl - k, s, st, rd);
        done += __shfl_sync(FULL, incl, 31);
      }
      em += done;
    }
    if (!r.write && lane == 0) {
      // An overflowed start keeps no emission.
      r.counts[s] = over ? 0 : (int)em;
      r.flags[s] = over;
      n_over += over;
      n_em += over ? 0 : em;
      n_rounds = rd > n_rounds ? rd : n_rounds;
      n_spill += spilled;
    }
    __syncwarp();
  }
  if (!r.write && lane == 0) {
    atomicAdd(r.stats + ST_EM, n_em);
    atomicAdd(r.stats + ST_STATES, n_states);
    atomicMax(r.stats + ST_ROUNDS, (u64)n_rounds);
    atomicAdd(r.stats + ST_OVER, n_over);
    atomicAdd(r.stats + ST_SPILL, n_spill);
    atomicAdd(r.stats + ST_MEMSORT, n_mem);
  }
}

// --- The JAX order: a block per chunk ---------------------------------------------

// Chunk blockIdx.x's staged emissions, start-major, stably sorted by round
// into out / out_pen: each warp counts the rounds of its share of the
// segment, the counts are scanned round-major (warp-minor), and each warp
// places its share in order, ranks among equal rounds by __match_any_sync.
// hist: ORDER_WARPS * T int32 a block in global memory, or null for shared
// memory.
__global__ void __launch_bounds__(ORDER_WARPS * 32, 1)
    beam_order_kernel(const Em* staged, const int* offsets, long long n, int nchunk, int T,
                      long long* out, float* out_pen, long long total, int* hist_global) {
  extern __shared__ int hist_smem[];
  const long long s_lo = (long long)blockIdx.x * nchunk;
  const long long s_hi = s_lo + nchunk < n ? s_lo + nchunk : n;
  const long long lo = offsets[s_lo], m = offsets[s_hi] - lo;
  if (m == 0) return;
  int* const hist = hist_global ? hist_global + (long long)blockIdx.x * ORDER_WARPS * T : hist_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < ORDER_WARPS * T; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long part = (m + ORDER_WARPS - 1) / ORDER_WARPS;
  const long long a = lo + (warp * part < m ? warp * part : m);
  const long long b = lo + ((warp + 1) * part < m ? (warp + 1) * part : m);
  int* const h = hist + (long long)warp * T;
  for (long long i = a + lane; i < b; i += 32) atomicAdd(h + staged[i].round, 1);
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int r0 = 0; r0 < T; r0 += 32) {
      const int rr = r0 + lane;
      int tot = 0;
      if (rr < T)
        for (int w = 0; w < ORDER_WARPS; ++w) {
          const int v = hist[w * T + rr];
          hist[w * T + rr] = tot;
          tot += v;
        }
      const int incl = warp_incl_scan(tot);
      if (rr < T)
        for (int w = 0; w < ORDER_WARPS; ++w) hist[w * T + rr] += carry + incl - tot;
      carry += __shfl_sync(FULL, incl, 31);
    }
  }
  __syncthreads();
  for (long long i0 = a; i0 < b; i0 += 32) {
    const long long i = i0 + lane;
    const bool in = i < b;
    Em e{0, 0, 0, 0u, 0.f, -1};
    if (in) e = staged[i];
    const unsigned peers = __match_any_sync(FULL, e.round);
    long long dst = 0;
    if (in) dst = lo + h[e.round] + __popc(peers & lt);
    __syncwarp();
    if (in && !(peers & lt)) h[e.round] += __popc(peers);
    __syncwarp();
    if (in) {
      out[dst] = e.si;
      out[total + dst] = e.me;
      out[2 * total + dst] = e.pat;
      out[3 * total + dst] = (long long)e.counts;
      out_pen[dst] = e.pen;
    }
  }
}


// Launches kernel fn on a persistent grid: as many blocks as the SMs hold at
// once, no more than need, nor than the global scratch has regions for.
template <typename K>
cudaError_t persistent(K* fn, const Tables& t, const Run& r, long long dyn, long long need,
                       long long per_block_spill, long long scratch_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, reinterpret_cast<const void*>(fn), POOL_THREADS, (size_t)dyn)) != cudaSuccess)
    return err;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > need) grid = need;
  if (per_block_spill && grid > scratch_bytes / per_block_spill)
    grid = scratch_bytes / per_block_spill;
  fn<<<(unsigned)grid, POOL_THREADS, (size_t)dyn, stream>>>(t, r);
  return cudaGetLastError();
}

template <typename SymT, bool CHIP>
cudaError_t launch(const Tables& t, const Run& r, const Layout& L, long long scratch_bytes,
                   cudaStream_t stream) {
  const long long tables = CHIP ? L.tables : 0;
  const long long spill = L.spill ? L.units * L.spill : 0;
  if (t.E >= 2) {
    // The sorted kernel takes its cap of keys as a third argument.
    const void* fn = reinterpret_cast<const void*>(&beam_sorted_kernel<SymT, CHIP>);
    const long long dyn = tables + L.ws;
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SORT_THREADS,
                                                             (size_t)dyn)) != cudaSuccess)
      return err;
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long need = (r.n + SORT_WARPS - 1) / SORT_WARPS;
    if (grid > need) grid = need;
    if (spill && grid > scratch_bytes / spill) grid = scratch_bytes / spill;
    beam_sorted_kernel<SymT, CHIP><<<(unsigned)grid, SORT_THREADS, (size_t)dyn, stream>>>(
        t, r, (int)sort_cap(t.Df, t.Dd, t.B));
    return cudaGetLastError();
  }
  // E = 1: the thread path over the run's starts, then the warp path over
  // the starts it handed on (their count is on the device: the grid is sized
  // for the run, and a warp with nothing to take returns at once).
  cudaError_t err = persistent(&beam_pool_thread_kernel<SymT, CHIP>, t, r, tables + L.light_ws,
                               (r.n + POOL_THREADS - 1) / POOL_THREADS, 0, 0, stream);
  if (err != cudaSuccess) return err;
  return persistent(&beam_pool_kernel<SymT, CHIP>, t, r, tables + L.ws,
                    (r.n + POOL_WARPS - 1) / POOL_WARPS, spill, scratch_bytes, stream);
}

bool aligned4(const void* p) { return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

}  // namespace

extern "C" {

// The kernels' constants, which ops/fuzzy.py mirrors: 0 SMEM_MAX, 1
// POOL_THREADS, 2 SORT_THREADS, 3 ORDER_WARPS, 4 ORDER_SMEM, 5 ENTRY_BYTES,
// 6 WARP_SORT_KEYS, 7 BATCH, 8 the stats' slots, 9 THREAD_POOL_WALKS, 10
// POOL_CHIP_WALKS, 11 SORT_CHIP_KEYS, 12 TABLES_SMEM_MAX; -1 past them.
int fac_beam_const(int i) {
  const int v[] = {SMEM_MAX,          POOL_THREADS,    SORT_THREADS,   ORDER_WARPS,
                   ORDER_SMEM,        ENTRY_BYTES,     WARP_SORT_KEYS, BATCH,
                   ST_SLOTS,          THREAD_POOL_WALKS, POOL_CHIP_WALKS, SORT_CHIP_KEYS,
                   TABLES_SMEM_MAX};
  return i >= 0 && i < (int)(sizeof(v) / sizeof(v[0])) ? v[i] : -1;
}

// The layout fac_beam_frontier gives a launch over these shapes (E, the
// edge widths Df / Dd, T rounds, N nodes, C classes, MO outputs a node,
// npat patterns, sym_bytes 1 or 4), into out int64 [8]: the warp path's
// warps a block, the entries a warp keeps on chip, the block's on-chip
// workspace bytes, a warp's global scratch bytes (0: none), the walks a pool
// thread keeps on chip, the thread path's on-chip bytes a block (E = 1), the
// tables' bytes, and 1 where they are staged into shared memory
// (ops/fuzzy.py::frontier_workspace, ::tables_bytes and ::tables_on_chip
// mirror it). Returns 0, or cudaErrorInvalidValue for shapes out of range.
int fac_beam_layout(int E, int Df, int Dd, int T, int N, int C, int MO, int npat, int sym_bytes,
                    void* out) {
  if (E < 1 || E > 6 || T < 1 || Df < 0 || Dd < 0 || N < 1 || C < 1 || MO < 1 || npat < 1 ||
      (sym_bytes != 1 && sym_bytes != 4) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(E, Df, Dd, T, N, C, MO, npat, sym_bytes, nullptr);
  const long long v[8] = {L.units, L.chip, L.ws, L.spill, L.light_chip, L.light_ws, L.tables,
                          L.on_chip};
  for (int i = 0; i < 8; ++i) static_cast<long long*>(out)[i] = v[i];
  return 0;
}

// One phase of the frontier over the run's n starts (int64 corpus
// positions): E == 1 launches the pool's thread path, then its warp path
// over the starts the thread path handed on; E = 2..6 the sorted kernel
// with B = 32 + 24 E. ids: u8 (sym_bytes 1) or int32 (4) [>= limit]; go,
// sb: [N, C] int32 / u8; et_* / ec_*: int32 [N, D*]; sim: f32 [C, C];
// out_count int32 [N], out_list int32 [N, MO], pat_len / pat_weight f32
// [npat], ceil f32 [N]. The layout is fac_beam_layout's: the tables go into
// shared memory where it says so, and scratch holds scratch_bytes of global
// scratch, at least a block's warps' (fac_beam_layout's units x spill)
// where a warp needs any, else null. flags u8 [n]: E >= 2 the overflowed
// starts, E = 1 the starts handed to the warp path, whose indices go to
// handed int32 [n]. write == 0: counts int32 [n] and flags written, stats
// int64 [ST_SLOTS] (zeroed by the caller) added to. write == 1: the starts
// whose counts are not 0 run again; offsets int32 [n + 1] (block_offsets of
// the counts) read, staged [total] (24 bytes each: si, me, pattern, counts,
// penalty, round) written. Returns the first launch error.
int fac_beam_frontier(const void* ids, int sym_bytes, long long limit, const void* go,
                      const void* sb, int N, int C, const void* et_full, const void* ec_full,
                      int Df, const void* et_deep, const void* ec_deep, int Dd, const void* sim,
                      const void* out_count, const void* out_list, int MO, const void* pat_len,
                      const void* pat_weight, int npat, const void* ceil, float max_pen,
                      float p_sub, float p_ins, float p_del, float p_swap, float floor_,
                      float slack, int E, int T, const void* starts, long long n, int write,
                      void* counts, const void* offsets, void* staged, long long total,
                      void* flags, void* handed, void* stats, void* scratch,
                      long long scratch_bytes, void* stream) {
  if (E < 1 || E > 6 || T < 1 || T + 2 >= (1 << 16) || n < 1 || n >= (1ll << 31) || N < 1 ||
      C < 1 || Df < 0 || Dd < 0 || MO < 1 || npat < 1 || (long long)N * C >= (1ll << 31) ||
      (long long)N * (Df > MO ? Df : MO) >= (1ll << 31) || (long long)C * C >= (1ll << 31) ||
      (sym_bytes != 1 && sym_bytes != 4) || pool_slots(Df, Dd, T) >= (1ll << 28))
    return (int)cudaErrorInvalidValue;
  const int B = 32 + 24 * E;
  Tables t{ids, limit, static_cast<const int*>(go), static_cast<const uint8_t*>(sb), N, C,
           static_cast<const int*>(et_full), static_cast<const int*>(ec_full), Df,
           static_cast<const int*>(et_deep), static_cast<const int*>(ec_deep), Dd,
           static_cast<const float*>(sim), static_cast<const int*>(out_count),
           static_cast<const int*>(out_list), MO, static_cast<const float*>(pat_len),
           static_cast<const float*>(pat_weight), npat, static_cast<const float*>(ceil),
           max_pen, p_sub, p_ins, p_del, p_swap, floor_, slack, E, T, B};
  const Layout L = layout_of(E, Df, Dd, T, N, C, MO, npat, sym_bytes, &t);
  t.o_ws = L.on_chip ? (int)L.tables : 0;
  const void* tabs[] = {go, sb, sim, out_count, out_list, pat_len, pat_weight, ceil};
  bool ok = (L.ws > L.light_ws ? L.ws : L.light_ws) <= SMEM_MAX;
  for (const void* p : tabs) ok = ok && (L.on_chip ? aligned4(p) : p != nullptr);
  if (L.on_chip) ok = ok && (Df == 0 || (aligned4(et_full) && aligned4(ec_full)));
  ok = ok && (L.spill == 0 || (scratch != nullptr && scratch_bytes >= L.units * L.spill));
  ok = ok && ids != nullptr && starts != nullptr && stats != nullptr && counts != nullptr &&
       flags != nullptr && (E >= 2 || handed != nullptr);
  ok = ok && (!write || (offsets != nullptr && staged != nullptr && total >= 1));
  if (!ok) return (int)cudaErrorInvalidValue;
  const Run r{static_cast<const long long*>(starts), n, write, static_cast<int*>(counts),
              static_cast<const int*>(offsets), static_cast<Em*>(staged), total,
              static_cast<uint8_t*>(flags), static_cast<int*>(handed), static_cast<u64*>(stats),
              (int)L.chip, static_cast<uint8_t*>(scratch), L.spill};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sym_bytes == 4) return (int)launch<int32_t, false>(t, r, L, scratch_bytes, s);
  return (int)(L.on_chip ? launch<uint8_t, true>(t, r, L, scratch_bytes, s)
                         : launch<uint8_t, false>(t, r, L, scratch_bytes, s));
}

// The JAX order of a run's staged emissions (fac_beam_frontier's write
// launch: start-major at offsets, int32 [n + 1]): a block per chunk of nchunk
// starts sorts its segment by round (0 .. T - 1), stably, into out int64 [4,
// total] (si, me, pattern, counts) and out_pen f32 [total]. hist: null for
// the round histograms in shared memory (ORDER_WARPS * T int32 must fit
// ORDER_SMEM), else int32 [chunks * ORDER_WARPS * T]. Returns the launch's
// cudaError_t.
int fac_beam_order(const void* staged, const void* offsets, long long n, int nchunk, int T,
                   void* out, void* out_pen, long long total, void* hist, void* stream) {
  if (staged == nullptr || offsets == nullptr || out == nullptr || out_pen == nullptr || n < 1 ||
      nchunk < 1 || T < 1 || T + 2 >= (1 << 16) || total < 1 ||
      (hist == nullptr && 4ll * ORDER_WARPS * T > ORDER_SMEM))
    return (int)cudaErrorInvalidValue;
  const long long chunks = (n + nchunk - 1) / nchunk;
  const size_t dyn = hist ? 0 : (size_t)4 * ORDER_WARPS * T;
  beam_order_kernel<<<(unsigned)chunks, ORDER_WARPS * 32, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Em*>(staged), static_cast<const int*>(offsets), n, nchunk, T,
      static_cast<long long*>(out), static_cast<float*>(out_pen), total, static_cast<int*>(hist));
  return (int)cudaGetLastError();
}

}  // extern "C"
