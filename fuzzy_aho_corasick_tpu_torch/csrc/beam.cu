// The beam frontier for Hopper (sm_90a): beam_pool_kernel (E = 1) and
// beam_sorted_kernel (E >= 2), each run twice around block_offsets_kernel.
//
// Replaces the JAX package's XLA device functions
// fuzzy_aho_corasick_tpu/ops/fuzzy.py::_fuzzy1_core / _fuzzy1_scan_kernel
// (:342-523, the E = 1 pool) and ::_expand + _dedup_compact +
// _fuzzy_scan_kernel (:57-340, the sorted E >= 2 beam): the per-start BFS of
// the reference (src/search.rs:418-1119) over the candidate starts of the
// engines the DP and many lanes decline. Plain torch versions:
// ops/fuzzy.py::_pool_chunk and ::_beam_chunk; wrappers ops/fuzzy.py::
// pool_frontier and ::sorted_frontier; the tables: ops/fuzzy.py::
// beam_tables (BeamTables.k32).
//
// What it computes. A run of n starts (whole chunks of nchunk starts, the
// JAX package's dispatch unit, the last one short) against the dense
// automaton. Start s walks T rounds from the root (node 0, j = me = 0, no
// edit, penalty +0): each round pops every state of its frontier once, with
// the exact, substitution, swap, insertion and deletion pushes and every
// push guard of ops/fuzzy.py::_expand (candidate()), f32 in the oracle's
// order (__fadd_rn and friends; the library is built with -fmad=false). The
// root round takes the full edge width Df, later rounds the deepest
// non-root degree Dd. Its emissions are (state, output pattern) pairs at
// output nodes whose similarity ((len - pen) / len) * weight passes the slack
// threshold, written as (s, me, pattern, counts) int64 [4, total] and the
// penalty f32 [total], in the JAX order (chunk, round, start, slot, output).
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
// The pass, per run (ops/fuzzy.py::_frontier_kernels): the count launch
// writes each (chunk, round, start)'s emissions into a grid laid out in the
// JAX order (chunk base nchunk * T, then round, then the start in its
// chunk: every entry written by its start) and adds the run's emissions,
// states expanded, lockstep rounds and overflowed starts into stats int64
// [4]; block_offsets scans the grid; the host reads stats (the only wait);
// the write launch runs every start again and writes each emission at
// offsets[g] plus the emissions before it in its (start, round).
//
// Design. A start's frontier never reads another's, so the JAX lockstep
// rounds become a loop inside one warp (E = 1) or one block (E >= 2) that
// ends when the start's frontier empties, and a persistent grid takes the
// starts in turn. E = 1: a warp per start, the pool walks on its lanes
// (ballot compaction keeps them in slot order, so a warp scan places the
// emissions), 16 bytes a walk in shared memory (POOL_WARPS starts a block).
// E >= 2: a block per start; candidates are appended (one shared atomic per
// warp), held as 16-byte keys that carry every field ((node, j, me) and
// (counts, the penalty's order bits)), sorted by a bitonic network whose
// comparators all put the lesser key first, so the ragged tail needs no
// padding, and deduplicated by a block scan, whose rank writes the next
// beam. The block's keys, max(2 Df + 3, B (2 Dd + 3)) candidates and B beam
// states, live in dynamic shared memory (opted in past 48 KiB); past
// SMEM_MAX they live in a global scratch per block of the grid.
//
// What bounds it on the H100. The bytes it must move: the starts read once,
// a symbol each, each emission's 36 bytes written once (0.0005-0.003 ms at
// phase 4j's shapes). Each round is a chain of dependent gathers (symbol,
// goto, edges, similarity, ceilings) and, at E >= 2, log^2 steps of a block
// sort, so the latency of a start's rounds, not bandwidth, sets its time;
// the persistent grid keeps as many starts in flight as the SMs hold. On
// the card (PERF.md §6) a launch took 0.67-1.06 ms over 4j's first runs
// (42 K-512 K starts), 2e-3 to 5e-4 of that bound; the wrapper took
// 1/32 to 1/261 of the plain torch rounds' time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Starts (warps) per block of the pool kernel.
constexpr int POOL_WARPS = 4;
// Threads per block of the sorted kernel (one start a block).
constexpr int SORT_THREADS = 128;
constexpr int SORT_WARPS = SORT_THREADS / 32;
// The most dynamic shared memory a block may opt in to on sm_90.
constexpr int SMEM_MAX = 232448;
// The sorted kernel's counters and per-warp sums, always in shared memory.
constexpr int MISC_BYTES = 256;
// Bytes a pool walk or a sort key takes in the workspace.
constexpr int ENTRY_BYTES = 16;

typedef unsigned long long u64;

struct Tables {
  const void* ids;
  long long limit;
  const int* go;
  const uint8_t* sb;
  int C;
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
  const float* ceil;
  float max_pen, p_sub, p_ins, p_del, p_swap, floor_, slack;
  int E, T, B;
};

struct Run {
  const long long* starts;
  long long n;
  int nchunk, write;
  int* counts;
  const int* offsets;
  long long* out;
  float* out_pen;
  long long total;
  uint8_t* overflow;
  long long* stats;
  uint8_t* scratch;
  long long ws_bytes;
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

// Workspace bytes per block (both kernels) and whether they fit on chip;
// ops/fuzzy.py::frontier_workspace is the mirror.
__host__ __device__ long long pool_slots(int Df, int Dd, int T) {
  return (2ll * Df + 2) + (long long)(T - 1) * (2ll * Dd + 2);
}
__host__ __device__ long long sort_cap(int Df, int Dd, int B) {
  const long long root = 2ll * Df + 3, deep = (long long)B * (2ll * Dd + 3);
  return root > deep ? root : deep;
}
long long ws_bytes_of(int E, int Df, int Dd, int T, int B) {
  return E == 1 ? (long long)POOL_WARPS * ENTRY_BYTES * pool_slots(Df, Dd, T)
                : (long long)ENTRY_BYTES * (sort_cap(Df, Dd, B) + B);
}
long long on_chip_bytes(int E, long long ws) { return E == 1 ? ws : ws + MISC_BYTES; }

template <typename SymT>
__device__ __forceinline__ int sym_at(const Tables& t, long long pos) {
  return pos < t.limit ? (int)__ldg(static_cast<const SymT*>(t.ids) + pos) : 0;
}

__device__ __forceinline__ int goto_of(const Tables& t, int node, int sym) {
  return __ldg(t.go + (long long)node * t.C + sym);
}

__device__ __forceinline__ bool sb_of(const Tables& t, int node, int sym) {
  return __ldg(t.sb + (long long)node * t.C + sym) != 0;
}

template <typename SymT>
__device__ __forceinline__ Ctx make_ctx(const Tables& t, long long pos0, const St& s) {
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
  c.exact_next = c.in_text ? goto_of(t, s.node, c.sym_j) : -1;
  return c;
}

// Column col of the expansion of c over edge width D (ops/fuzzy.py::_expand:
// exact, D substitutions, swap, insertion, D deletions): the candidate, node
// -1 where a push guard fails.
__device__ __forceinline__ St candidate(const Tables& t, const Ctx& c, int col, int D,
                                        const int* et, const int* ec) {
  const St& s = c.s;
  St o{-1, s.j + 1, s.j + 1, s.counts, s.pen};
  bool valid = false;
  int cn = -1;
  if (col == 0) {
    valid = c.in_text;
    cn = c.exact_next;
  } else if (col <= D) {
    // Substitution over edge col - 1 (src/search.rs:803-874).
    const int tn = __ldg(et + (long long)s.node * D + col - 1);
    cn = tn;
    if (tn >= 0 && c.in_text && c.can_edit && tn != c.exact_next) {
      const int cls = __ldg(ec + (long long)s.node * D + col - 1);
      const float sm = __ldg(t.sim + (long long)cls * t.C + c.sym_j);
      const float pnl = __fmul_rn(t.p_sub, __fsub_rn(1.0f, sm));
      valid = !(sm < t.floor_) && !(pnl > c.remaining);
      // Last-edit dead-end filter (src/search.rs:839-847).
      if (valid && c.is_last)
        valid = __ldg(t.out_count + tn) > 0 || (c.in_text2 && sb_of(t, tn, c.sym_j1));
      o.counts = s.counts + 0x10000u;
      o.pen = __fadd_rn(s.pen, pnl);
    }
  } else if (col == D + 1) {
    // Swap (src/search.rs:935-989).
    const int mid = c.in_text2 ? goto_of(t, s.node, c.sym_j1) : -1;
    cn = mid >= 0 ? goto_of(t, mid, c.sym_j) : -1;
    valid = c.in_text2 && t.p_swap <= c.remaining && c.can_edit && cn >= 0;
    o.j = o.me = s.j + 2;
    o.counts = s.counts + 0x1000000u;
    o.pen = __fadd_rn(s.pen, t.p_swap);
  } else if (col == D + 2) {
    // Insertion (src/search.rs:994-1029).
    cn = s.node;
    valid = c.in_text && (s.me != 0 || s.j != 0) && t.p_ins <= c.remaining && c.can_edit &&
            !(c.is_last && __ldg(t.out_count + s.node) == 0 &&
              !(c.in_text2 && sb_of(t, s.node, c.sym_j1)));
    o.me = s.me;
    o.counts = s.counts + 1u;
    o.pen = __fadd_rn(s.pen, t.p_ins);
  } else {
    // Deletion over edge col - D - 3 (src/search.rs:1035-1089).
    const int tn = __ldg(et + (long long)s.node * D + col - D - 3);
    cn = tn;
    valid = tn >= 0 && c.can_edit && t.p_del <= c.remaining &&
            !(c.is_last && __ldg(t.out_count + tn) == 0 && !(c.in_text && sb_of(t, tn, c.sym_j)));
    o.j = s.j;
    o.me = s.me;
    o.counts = s.counts + 0x100u;
    o.pen = __fadd_rn(s.pen, t.p_del);
  }
  // Per-node prune ceiling at pop time (src/search.rs:637-642).
  if (valid && cn >= 0 && !(o.pen > __ldg(t.ceil + cn))) o.node = cn;
  return o;
}

// Whether output column o of node passes the slack threshold, and its
// pattern (ops/fuzzy.py::_emit).
__device__ __forceinline__ int emitted(const Tables& t, int node, int o, float pen) {
  const int p = __ldg(t.out_list + (long long)node * t.MO + o);
  if (p < 0) return -1;
  const float total = __ldg(t.pat_len + p);
  const float sim = __fmul_rn(__fdiv_rn(__fsub_rn(total, pen), total), __ldg(t.pat_weight + p));
  return sim >= t.slack ? p : -1;
}

__device__ __forceinline__ int emit_count(const Tables& t, const St& s) {
  if (s.node < 0 || __ldg(t.out_count + s.node) <= 0) return 0;
  int k = 0;
  for (int o = 0; o < t.MO; ++o) k += emitted(t, s.node, o, s.pen) >= 0;
  return k;
}

__device__ __forceinline__ void emit_write(const Tables& t, const Run& r, long long at,
                                           long long si, const St& s) {
  if (s.node < 0 || __ldg(t.out_count + s.node) <= 0) return;
  for (int o = 0; o < t.MO; ++o) {
    const int p = emitted(t, s.node, o, s.pen);
    if (p < 0) continue;
    r.out[at] = si;
    r.out[r.total + at] = s.me;
    r.out[2 * r.total + at] = p;
    r.out[3 * r.total + at] = (long long)s.counts;
    r.out_pen[at] = s.pen;
    ++at;
  }
}

// The count grid's entry of (start s, round rd): chunks of nchunk * T
// entries, round-major inside a chunk, the last chunk short.
struct Grid {
  long long base;
  long long len;
  __device__ Grid(const Run& r, int T, long long s) {
    const long long c = s / r.nchunk;
    const long long left = r.n - c * r.nchunk;
    len = left < r.nchunk ? left : r.nchunk;
    base = c * r.nchunk * T + (s - c * r.nchunk);
  }
  __device__ long long at(int rd) const { return base + (long long)rd * len; }
};

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += x;
  }
  return v;
}

// --- E = 1: a warp per start -------------------------------------------------

// A pool walk as 16 bytes: node, j << 16 | me, counts, penalty.
struct Pool {
  int* node;
  int* jme;
  unsigned* counts;
  float* pen;
  __device__ St get(int i) const {
    return St{node[i], jme[i] >> 16, jme[i] & 0xffff, counts[i], pen[i]};
  }
  __device__ void put(int i, const St& s) const {
    node[i] = s.node;
    jme[i] = (s.j << 16) | s.me;
    counts[i] = s.counts;
    pen[i] = s.pen;
  }
};

// The round's emissions of the pool's n walks (in slot order) and of s0
// (slot P, last): the count, and in the write pass the emissions at base.
__device__ int pool_emit(const Tables& t, const Run& r, const Pool& pool, int n, const St& s0,
                         long long si, long long base) {
  const int lane = threadIdx.x & 31;
  int done = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    St s{-1, 0, 0, 0u, 0.f};
    if (i < n) s = pool.get(i);
    const int k = emit_count(t, s);
    const int incl = warp_incl_scan(k);
    if (r.write && k) emit_write(t, r, base + done + incl - k, si, s);
    done += __shfl_sync(FULL, incl, 31);
  }
  const int k0 = emit_count(t, s0);
  if (r.write && k0 && lane == 0) emit_write(t, r, base + done, si, s0);
  return done + k0;
}

// Appends the live columns [1, W) of the expansion of c (width D) to the pool
// in column order; returns the column-0 candidate (the next s0).
template <typename SymT>
__device__ St pool_expand(const Tables& t, const Ctx& c, int D, const int* et, const int* ec,
                          const Pool& pool, int& n) {
  const int lane = threadIdx.x & 31;
  const int W = 2 * D + 3;
  St s0{-1, 0, 0, 0u, 0.f};
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int col = c0 + lane;
    St o{-1, 0, 0, 0u, 0.f};
    if (col < W) o = candidate(t, c, col, D, et, ec);
    if (c0 == 0) {
      s0.node = __shfl_sync(FULL, o.node, 0);
      s0.j = s0.me = __shfl_sync(FULL, o.j, 0);
    }
    const bool spawn = col >= 1 && o.node >= 0;
    const unsigned m = __ballot_sync(FULL, spawn);
    if (spawn) pool.put(n + __popc(m & ((1u << lane) - 1)), o);
    n += __popc(m);
  }
  __syncwarp();
  return s0;
}

template <typename SymT>
__global__ void __launch_bounds__(POOL_WARPS * 32)
    beam_pool_kernel(Tables t, Run r, int P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * POOL_WARPS + warp;
  const long long nw = (long long)gridDim.x * POOL_WARPS;
  const long long per_warp = (long long)ENTRY_BYTES * P;
  uint8_t* ws = (r.scratch ? r.scratch + blockIdx.x * r.ws_bytes : smem) + warp * per_warp;
  const Pool pool{reinterpret_cast<int*>(ws), reinterpret_cast<int*>(ws) + P,
                  reinterpret_cast<unsigned*>(ws) + 2 * P, reinterpret_cast<float*>(ws) + 3 * P};
  long long n_states = 0, n_em = 0;
  int n_rounds = 0;
  for (long long s = gw; s < r.n; s += nw) {
    const long long pos0 = r.starts[s];
    const Grid g(r, t.T, s);
    int n = 0, rounds = 1, rd = 0;
    long long em = 0;
    // Round 0: the root at full width (the root never reappears).
    St s0 = pool_expand<SymT>(t, make_ctx<SymT>(t, pos0, St{0, 0, 0, 0u, 0.f}), t.Df,
                              t.et_full, t.ec_full, pool, n);
    n_states += 1;
    for (;;) {
      const long long base = r.write ? r.offsets[g.at(rd)] : 0;
      const int k = pool_emit(t, r, pool, n, s0, s, base);
      if (!r.write && lane == 0) r.counts[g.at(rd)] = k;
      em += k;
      if (++rd >= t.T || (n == 0 && s0.node < 0)) break;
      ++rounds;
      // 1) every pool walk takes its exact transition, with the push-time
      //    ceiling (src/search.rs:637-642); the dead leave, the order stays.
      int keep = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        St w{-1, 0, 0, 0u, 0.f};
        if (i < n) {
          w = pool.get(i);
          const long long pos = pos0 + w.j;
          int nxt = pos < t.limit ? goto_of(t, w.node, sym_at<SymT>(t, pos)) : -1;
          if (nxt >= 0 && w.pen > __ldg(t.ceil + nxt)) nxt = -1;
          w.node = nxt;
          w.j = w.me = w.j + 1;
        }
        __syncwarp();
        const bool live = w.node >= 0;
        const unsigned m = __ballot_sync(FULL, live);
        if (live) pool.put(keep + __popc(m & ((1u << lane) - 1)), w);
        keep += __popc(m);
        __syncwarp();
      }
      n = keep;
      // 2) the 0-edit walk at the deep width: its exact step, and the
      //    round's 1-edit spawns after every older slot.
      if (s0.node >= 0) {
        n_states += 1;
        s0 = pool_expand<SymT>(t, make_ctx<SymT>(t, pos0, St{s0.node, s0.j, s0.j, 0u, 0.f}),
                               t.Dd, t.et_deep, t.ec_deep, pool, n);
      }
    }
    if (!r.write && lane == 0)
      for (int z = rd; z < t.T; ++z) r.counts[g.at(z)] = 0;
    n_em += em;
    n_rounds = rounds > n_rounds ? rounds : n_rounds;
  }
  if (!r.write && lane == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(r.stats), (unsigned long long)n_em);
    atomicAdd(reinterpret_cast<unsigned long long*>(r.stats + 1), (unsigned long long)n_states);
    atomicMax(reinterpret_cast<unsigned long long*>(r.stats + 2), (unsigned long long)n_rounds);
  }
}

// --- E >= 2: a block per start ----------------------------------------------

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

// Inclusive scan of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = warp_incl_scan(v);
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < SORT_WARPS; ++i) {
    const int y = warp_sums[i];
    off += i < w ? y : 0;
    tot += y;
  }
  __syncthreads();
  total = tot;
  return x + off;
}

__device__ __forceinline__ void cmp_swap(u64* hi, u64* lo, int a, int b) {
  const u64 ha = hi[a], hb = hi[b], la = lo[a], lb = lo[b];
  if (hb < ha || (hb == ha && lb < la)) {
    hi[a] = hb;
    hi[b] = ha;
    lo[a] = lb;
    lo[b] = la;
  }
}

// Ascending sort of the m keys (hi, lo): a bitonic network of the next power
// of two whose every comparator puts the lesser key at the lower index (the
// first step of each merge compares mirrored pairs), so the keys past m act
// as +inf and their comparators are skipped.
__device__ void block_sort(u64* hi, u64* lo, int m) {
  if (m <= 1) return;
  int np2 = 1;
  while (np2 < m) np2 <<= 1;
  const int pairs = np2 >> 1;
  for (int k = 2; k <= np2; k <<= 1) {
    const int half = k >> 1;
    for (int i = threadIdx.x; i < pairs; i += SORT_THREADS) {
      const int blk = i / half, off = i - blk * half;
      const int a = blk * k + off, b = blk * k + k - 1 - off;
      if (b < m) cmp_swap(hi, lo, a, b);
    }
    __syncthreads();
    for (int j = half >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < pairs; i += SORT_THREADS) {
        const int a = 2 * j * (i / j) + i % j;
        if (a + j < m) cmp_swap(hi, lo, a, a + j);
      }
      __syncthreads();
    }
  }
}

template <typename SymT>
__global__ void __launch_bounds__(SORT_THREADS) beam_sorted_kernel(Tables t, Run r, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* misc = reinterpret_cast<int*>(smem);  // [0] candidates, [8..] warp sums
  int* warp_sums = misc + 8;
  uint8_t* ws = r.scratch ? r.scratch + blockIdx.x * r.ws_bytes : smem + MISC_BYTES;
  u64* c_hi = reinterpret_cast<u64*>(ws);
  u64* c_lo = c_hi + cap;
  u64* b_hi = c_lo + cap;
  u64* b_lo = b_hi + t.B;
  const int lane = threadIdx.x & 31;
  long long n_states = 0, n_em = 0, n_over = 0;
  int n_rounds = 0;
  for (long long s = blockIdx.x; s < r.n; s += gridDim.x) {
    if (r.write && r.overflow[s]) continue;
    const long long pos0 = r.starts[s];
    const Grid g(r, t.T, s);
    if (threadIdx.x == 0) {
      const St root{0, 0, 0, 0u, 0.f};
      b_hi[0] = key_hi(root);
      b_lo[0] = key_lo(root);
    }
    int nb = 1, rd = 0;
    bool over = false;
    long long em = 0;
    for (; rd < t.T && nb > 0; ++rd) {
      // Expansion: a thread per (state, column); the live candidates are
      // appended in no fixed order (the sort orders them).
      const bool root = rd == 0;
      const int D = root ? t.Df : t.Dd;
      const int* et = root ? t.et_full : t.et_deep;
      const int* ec = root ? t.ec_full : t.ec_deep;
      const int W = 2 * D + 3;
      if (threadIdx.x == 0) misc[0] = 0;
      __syncthreads();
      n_states += nb;
      for (int i0 = 0; i0 < nb * W; i0 += SORT_THREADS) {
        const int i = i0 + threadIdx.x;
        St o{-1, 0, 0, 0u, 0.f};
        if (i < nb * W) {
          const int b = i / W;
          const Ctx c = make_ctx<SymT>(t, pos0, decode(b_hi[b], b_lo[b]));
          o = candidate(t, c, i - b * W, D, et, ec);
        }
        const bool live = o.node >= 0;
        const unsigned m = __ballot_sync(FULL, live);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(misc, __popc(m));
        at = __shfl_sync(FULL, at, 0) + __popc(m & ((1u << lane) - 1));
        if (live) {
          c_hi[at] = key_hi(o);
          c_lo[at] = key_lo(o);
        }
      }
      __syncthreads();
      const int mc = misc[0];
      block_sort(c_hi, c_lo, mc);
      // The first of each (node, j, me, counts) is kept; its rank is its slot.
      int kept = 0;
      for (int i0 = 0; i0 < mc; i0 += SORT_THREADS) {
        const int i = i0 + threadIdx.x;
        int f = 0;
        u64 h = 0, l = 0;
        if (i < mc) {
          h = c_hi[i];
          l = c_lo[i];
          f = i == 0 || h != c_hi[i - 1] || (l >> 32) != (c_lo[i - 1] >> 32);
        }
        int tot;
        const int rank = kept + block_scan(f, warp_sums, tot) - f;
        if (f && rank < t.B) {
          b_hi[rank] = h;
          b_lo[rank] = l;
        }
        kept += tot;
      }
      if (kept > t.B) {
        over = true;
        ++rd;
        break;
      }
      nb = kept;
      __syncthreads();
      // The round's emissions, slot by slot.
      const long long base = r.write ? r.offsets[g.at(rd)] : 0;
      int done = 0;
      for (int b0 = 0; b0 < nb; b0 += SORT_THREADS) {
        const int b = b0 + threadIdx.x;
        St st{-1, 0, 0, 0u, 0.f};
        if (b < nb) st = decode(b_hi[b], b_lo[b]);
        const int k = emit_count(t, st);
        int tot;
        const int incl = block_scan(k, warp_sums, tot);
        if (r.write && k) emit_write(t, r, base + done + incl - k, s, st);
        done += tot;
      }
      if (!r.write && threadIdx.x == 0) r.counts[g.at(rd)] = done;
      em += done;
    }
    if (!r.write && threadIdx.x == 0) {
      // An overflowed start keeps no emission: its earlier rounds count 0.
      for (int z = over ? 0 : rd; z < t.T; ++z) r.counts[g.at(z)] = 0;
      r.overflow[s] = over;
      n_over += over;
      n_em += over ? 0 : em;
      n_rounds = rd > n_rounds ? rd : n_rounds;
    }
    __syncthreads();
  }
  if (!r.write && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(r.stats), (unsigned long long)n_em);
    atomicAdd(reinterpret_cast<unsigned long long*>(r.stats + 1), (unsigned long long)n_states);
    atomicMax(reinterpret_cast<unsigned long long*>(r.stats + 2), (unsigned long long)n_rounds);
    atomicAdd(reinterpret_cast<unsigned long long*>(r.stats + 3), (unsigned long long)n_over);
  }
}

template <typename SymT>
cudaError_t launch(const Tables& t, const Run& r, int grid, cudaStream_t stream) {
  const long long ws = ws_bytes_of(t.E, t.Df, t.Dd, t.T, t.B);
  const size_t dyn = r.scratch ? (t.E == 1 ? 0 : MISC_BYTES) : (size_t)on_chip_bytes(t.E, ws);
  const void* fn = t.E == 1 ? reinterpret_cast<const void*>(&beam_pool_kernel<SymT>)
                            : reinterpret_cast<const void*>(&beam_sorted_kernel<SymT>);
  const int threads = t.E == 1 ? POOL_WARPS * 32 : SORT_THREADS;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return err;
  const long long per_block = t.E == 1 ? POOL_WARPS : 1;
  const long long need = (r.n + per_block - 1) / per_block;
  if (grid <= 0) {
    // The smem path: as many blocks as the SMs hold at once.
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dyn)) !=
        cudaSuccess)
      return err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (grid > need) grid = (int)need;
  if (t.E == 1)
    beam_pool_kernel<SymT><<<grid, threads, dyn, stream>>>(t, r, (int)pool_slots(t.Df, t.Dd, t.T));
  else
    beam_sorted_kernel<SymT><<<grid, threads, dyn, stream>>>(t, r, (int)sort_cap(t.Df, t.Dd, t.B));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may take (a workspace past it goes
// to the global scratch), the sorted kernel's counters beside its keys,
// and the pool kernel's starts per block.
int fac_beam_smem_max() { return SMEM_MAX; }
int fac_beam_misc_bytes() { return MISC_BYTES; }
int fac_beam_pool_warps() { return POOL_WARPS; }

// One launch of the frontier over the run's n starts (int64 corpus
// positions). ids: u8 (sym_bytes 1) or int32 (4) [>= limit]; go, sb: [N, C]
// int32 / u8; et_* / ec_*: int32 [N, D*]; sim: f32 [C, C]; out_count int32
// [N], out_list int32 [N, MO], pat_len / pat_weight f32 [patterns], ceil f32
// [N]. E == 1 runs the pool kernel, E = 2..6 the sorted kernel with B = 32 +
// 24 E. ws_bytes: the workspace bytes per block (ops/fuzzy.py::
// frontier_workspace, checked against ws_bytes_of); scratch: null for the smem
// path (ws_bytes must fit), else grid * ws_bytes bytes. write == 0: counts
// int32 [n * T] and overflow u8 [n] (E >= 2) written, stats int64 [4]
// (zeroed by the caller) added to: emissions, states expanded, rounds (the
// most of any start), overflowed starts. write == 1: offsets int32 [n * T +
// 1] (block_offsets of the counts), overflow read, out int64 [4, total] and
// out_pen f32 [total] written. Returns the launch's cudaError_t.
int fac_beam_frontier(const void* ids, int sym_bytes, long long limit, const void* go,
                      const void* sb, int N, int C, const void* et_full, const void* ec_full,
                      int Df, const void* et_deep, const void* ec_deep, int Dd, const void* sim,
                      const void* out_count, const void* out_list, int MO, const void* pat_len,
                      const void* pat_weight, const void* ceil, float max_pen, float p_sub,
                      float p_ins, float p_del, float p_swap, float floor_, float slack, int E,
                      int T, const void* starts, long long n, int nchunk, int write,
                      void* counts, const void* offsets, void* out, void* out_pen,
                      long long total, void* overflow, void* stats, void* scratch,
                      long long ws_bytes, int grid, void* stream) {
  const int B = 32 + 24 * E;
  const long long ws = ws_bytes_of(E, Df, Dd, T, B);
  if (E < 1 || E > 6 || T < 1 || T + 2 >= (1 << 16) || n < 1 || nchunk < 1 || N < 1 || C < 1 ||
      Df < 0 || Dd < 0 || MO < 1 || n * (long long)T >= (1ll << 31) ||
      (long long)N * C >= (1ll << 31) || (sym_bytes != 1 && sym_bytes != 4) || ws != ws_bytes ||
      (scratch == nullptr && on_chip_bytes(E, ws) > SMEM_MAX) ||
      (scratch != nullptr && grid < 1) ||
      pool_slots(Df, Dd, T) >= (1ll << 28) || ids == nullptr || go == nullptr || sb == nullptr ||
      starts == nullptr || stats == nullptr || (E >= 2 && overflow == nullptr) ||
      (write == 0 && counts == nullptr) ||
      (write != 0 && (offsets == nullptr || out == nullptr || out_pen == nullptr || total < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const Tables t{ids, limit,
                 static_cast<const int*>(go), static_cast<const uint8_t*>(sb), C,
                 static_cast<const int*>(et_full), static_cast<const int*>(ec_full), Df,
                 static_cast<const int*>(et_deep), static_cast<const int*>(ec_deep), Dd,
                 static_cast<const float*>(sim), static_cast<const int*>(out_count),
                 static_cast<const int*>(out_list), MO, static_cast<const float*>(pat_len),
                 static_cast<const float*>(pat_weight), static_cast<const float*>(ceil),
                 max_pen, p_sub, p_ins, p_del, p_swap, floor_, slack, E, T, B};
  const Run r{static_cast<const long long*>(starts), n, nchunk, write,
              static_cast<int*>(counts), static_cast<const int*>(offsets),
              static_cast<long long*>(out), static_cast<float*>(out_pen), total,
              static_cast<uint8_t*>(overflow), static_cast<long long*>(stats),
              static_cast<uint8_t*>(scratch), ws};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(sym_bytes == 1 ? launch<uint8_t>(t, r, scratch ? grid : 0, s)
                              : launch<int32_t>(t, r, scratch ? grid : 0, s));
}

}  // extern "C"
