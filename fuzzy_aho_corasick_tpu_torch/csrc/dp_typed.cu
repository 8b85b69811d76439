// Banded Damerau DP with edit-type-vector channels, alone and as the
// expansion -> DP step of one corpus slice, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_banded_dp_typed (and, in front
// of it, _expand_candidates), the typed branch of _dp_pipeline_jit, which
// XLA compiled per engine from an unrolled graph of Lmax x B x NCH vector
// ops; its emission, _emit_rows_typed, is the list step's count_emit_kernel
// (dp_list.cu). Plain torch versions (ops/verify_dp.py): expand_candidates,
// typed_dp_torch (banded_dp_typed_torch, then typed_decisions_torch), and
// banded_dp_typed_torch for the DP alone; wrappers verify_dp.typed_expand,
// typed_dp, banded_dp_typed (and typed_emit, which launches
// count_emit_kernel).
//
// What it computes. Per candidate (field f, start s) the recurrences of
// banded_dp.cuh without counts and without a dead-end filter, over NCH
// channels that are edit-type vectors (insertions, deletions,
// substitutions, swaps): an edit of one type arrives in channel ch from the
// channel with one edit of that type less (the graph table), and only where
// the source's edit total and that type's count are below the caps of a
// node on the path: substitution, deletion and the emission channel's
// trailing deletion read the caps of row i-1 (row 0: the root's), insertion
// and swap those of row i. Caps compare as integers. f32 order, guards,
// strict-< merges (exact, substitution, swap, deletion, then insertions
// ascending b over the updated band b-1), ceilings and the latch at
// i == depth are banded_dp.cu's. Emission: per band and output slot, the
// strict-< minimum in channel order over the channels the pattern's limits
// class admits, the winning channel's static counts, and the f32 test
// ((pl - pen) / pl) * pw >= bound of dp_pipeline.cu.
//
// What bounds it on the H100, and the design. Like the count-channel DP it
// is bound by the dependent-instruction latency of each candidate's row
// loop, not by bytes: slice 1 of the typed main path is ~10^4 candidates of
// ~10 rows. So every live candidate gets its own worker and they all start
// at once; the step is three launches and one host wait:
//   1. typed_expand_kernel, a thread per (combo, hit) item (items
//      combo-major over the hits h0..K-1; a hit before h0 is read only as
//      the predecessor of hit h0): the candidate list (field, start, combo)
//      in item order, and its total, on the card. Its work is a few bytes
//      an item (~1 MB a slice), so its cost is launches and host calls; it
//      was a count pass and a write pass around block_offsets_kernel, three
//      launches that each re-read the hits. It is one launch now: at most one candidate per item, so a block's candidates
//      are a ballot and a scan of its 8 warp counts away; the block takes
//      its offset by decoupled look-back over the status words of the
//      blocks before it and writes its candidates at once. The look-back
//      is lookback.cuh's, which the chained block_offsets_kernel shares: a
//      tile from a ticket (so every block waited on has started),
//      epoch-tagged status words that live across calls (so nothing is
//      cleared: no memset), release stores and acquire loads. Here all
//      TE_THREADS threads of a block read the words of TE_THREADS blocks
//      before it in one round.
//   2. the DP over the list. Where the B x NCH cells fit a group of G = 8,
//      16 or 32 lanes (15 for edits(1) with 5 channels), typed_dp_kernel<G>
//      holds one cell per lane in registers: the arrivals from row i-1 and
//      i-2 and the insertion pass band by band are shuffles within the
//      group; its grid covers the item bound (the candidate total is on the
//      card only) and blocks past the total leave at once. Past 32 cells
//      (70 for edits(2).substitutions(1), up to 13 x 96) a warp per
//      candidate kept five rows of B x NCH floats in shared memory, re-read
//      ~10 graph words per cell and row, ran B - 1 insertion rounds and a
//      ceiling pass each behind a __syncwarp, walked every row to the depth
//      though most candidates die in a few, and launched a block per four
//      items of the bound. typed_dp_rows_kernel<E, S, G> gives a candidate
//      a group of G = 16 lanes (NCH <= 16: two candidates a warp) or 32,
//      channel ch = s G + lane in slot s < S of a lane (S = 1..3: NCH up
//      to 96), and holds the B bands of each slot's rows i-1, i-2 and of
//      its emission channel in registers (E and S template parameters, so
//      band and slot indices are compile-time). Substitution and swap come
//      from band b of the source channel, deletion and the trailing
//      deletion from band b+1, the insertion from band b-1 of the same row,
//      ascending b: each a shuffle from the source's lane (S shuffles where
//      a lane has S slots, the source's slot picked). The lane's graph
//      constants (sources, their edit totals and type counts) are read once
//      per kernel, the band symbols slide in registers (one staged load a
//      row), and the group stops once no value a later row reads (rows i,
//      i-1, the emission channel of row i) is finite. Its grid holds four
//      waves of the card's resident blocks and their groups stride over
//      the list with no block barrier. The path's per-row values (class, ceiling, the two
//      caps rows) and the haystack window are staged in shared memory by
//      the group's lanes in parallel before the row loop, so the dependent
//      reads node -> ceiling / caps are paid once per candidate, not once
//      per row. The DP runs once: per emission channel (band, output slot)
//      it keeps the winning penalty bits and channel, or no row, in dec
//      [nce, items], and counts its rows per (channel, tile of TYPED_TILE
//      candidates), per channel and in all, and writes the candidates'
//      total last: count_dp's layout (dp_list.cu).
//   3. the host reads the rows' and the candidates' totals (the last two
//      words of the row counts, the step's host wait);
//   4. count_emit_kernel (dp_list.cu), the list step's emission, with the
//      graph's packed-counts column for a row's counts: a block per
//      (channel, tile) pair placed by the channel totals and the tile
//      counts before it, the rows staged in shared memory and stored as one
//      stretch, and the tags (channel * n_combo + combo) where asked, in
//      (channel, candidate) order, which is (channel, item) order. It
//      replaces a block per tile that walked the channels in turn behind a
//      block_offsets launch over the row counts.
// NCH, E, the graph and the admissibility table are run-time tables: one
// instance of each kernel serves every engine.

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>
#include <vector>

#include "lookback.cuh"

namespace {

constexpr int TY_THREADS = 128;   // the DP-only kernel: a warp per candidate
constexpr int TY_WARPS = TY_THREADS / 32;
constexpr int TD_THREADS = 256;   // the DP over the list with register cells
constexpr int TR_THREADS = 128;   // the DP over the list past 32 cells: groups of 16 or 32
constexpr int TR_WAVES = 4;       // its grid: this many times the blocks the card holds at once
constexpr int TE_THREADS = 256;   // threads of an expansion block
constexpr int TE_WARPS = TE_THREADS / 32;
constexpr int TE_ITEMS = 8;       // items per thread: a block's tile of TE_TILE items
constexpr int TE_TILE = TE_THREADS * TE_ITEMS;
constexpr int TE_SLOTS = TE_ITEMS * TE_WARPS;   // (item row, warp) counts of a tile
constexpr int TE_PER_LANE = (TE_SLOTS + 31) / 32;  // of them scanned by each lane of warp 0
constexpr int TYPED_TILE = 1024;  // candidates per row-count tile (dp_list.cu's LIST_TILE)
constexpr int MAX_E = 6;
constexpr int MAX_NCH = 96;
constexpr int MAX_CHANNELS = 128;  // B * MO emission channels a call may have
// Columns of the graph table: source channel of the substitution, insertion,
// deletion and swap arrival (-1: none), the vector's sum, its insertions,
// deletions, substitutions and swaps, its packed counts.
constexpr int GCOLS = 10;
constexpr int G_SUB = 0, G_INS = 1, G_DEL = 2, G_SWAP = 3, G_SUM = 4, G_NI = 5, G_ND = 6,
              G_NS = 7, G_NW = 8, G_CNT = 9;
static_assert(TYPED_TILE % (TD_THREADS / 8) == 0, "a block's candidates lie in one tile");
static_assert(MAX_CHANNELS <= TD_THREADS, "a thread per emission channel flushes the counts");
static_assert(3 * 32 >= MAX_NCH, "three channel slots of a warp hold every channel");

struct TypedCore {
  const void* ids;            // dense class ids, u8 or int32 [npad]
  int ids_u8;
  long long limit;            // positions >= limit are out of text
  const int32_t* path_cls;    // [F, Lmax]
  const int32_t* path_node;   // [F, Lmax]
  const int32_t* depth;       // [F]
  int Lmax;
  const float* sim;           // [C, C]
  int C;
  const float* node_ceil;     // [N]
  float max_pen, p_sub, p_ins, p_del, p_swap, floor_;
  int E;
  const int32_t* graph;       // [nch, GCOLS]
  int nch;
  const int32_t* node_caps;   // [N, 5]: edits, insertions, deletions, substitutions, swaps
  const int32_t* root_caps;   // [5]: the caps of path row 0
};

__device__ __forceinline__ int hay_at(const TypedCore& a, long long p) {
  if (p < 0 || p >= a.limit) return -1;
  return a.ids_u8 ? (int)__ldg(static_cast<const uint8_t*>(a.ids) + p)
                  : __ldg(static_cast<const int32_t*>(a.ids) + p);
}

__device__ __forceinline__ bool fin(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);  // false for +-inf and NaN
}

// What row i of the loop reads of the path: its class and the one before,
// the ceiling of its node, and the caps of rows i-1 and i that the arrivals
// test.
struct RowVals {
  int pc, pc_prev;
  float ceil_i;
  int ce_1, cd_1, cs_1;  // row i-1: edits, deletions, substitutions
  int ce_0, ci_0, cw_0;  // row i: edits, insertions, swaps
};

// Row values read from the path tables in device memory, row by row.
struct GlobalRows {
  const TypedCore* a;
  const int32_t* pcls;
  const int32_t* pnode;
  __device__ __forceinline__ RowVals operator()(int i) const {
    RowVals r;
    r.pc = __ldg(pcls + i - 1);
    r.pc_prev = __ldg(pcls + (i >= 2 ? i - 2 : 0));
    const int pn = __ldg(pnode + i - 1);
    r.ceil_i = __ldg(a->node_ceil + pn);
    const int32_t* c1 = i == 1 ? a->root_caps : a->node_caps + 5ll * __ldg(pnode + i - 2);
    const int32_t* c0 = a->node_caps + 5ll * pn;
    r.ce_1 = __ldg(c1);
    r.cd_1 = __ldg(c1 + 2);
    r.cs_1 = __ldg(c1 + 3);
    r.ce_0 = __ldg(c0);
    r.ci_0 = __ldg(c0 + 1);
    r.cw_0 = __ldg(c0 + 4);
    return r;
  }
};

// Row values staged in shared memory: cls [Lmax], ceil [Lmax], caps
// [(Lmax + 1) * 5] with path row 0 the root's caps.
struct StagedRows {
  const int32_t* cls;
  const float* ceil;
  const int32_t* caps;
  __device__ __forceinline__ RowVals operator()(int i) const {
    RowVals r;
    r.pc = cls[i - 1];
    r.pc_prev = cls[i >= 2 ? i - 2 : 0];
    r.ceil_i = ceil[i - 1];
    const int32_t* c1 = caps + 5 * (i - 1);
    const int32_t* c0 = caps + 5 * i;
    r.ce_1 = c1[0];
    r.cd_1 = c1[2];
    r.cs_1 = c1[3];
    r.ce_0 = c0[0];
    r.ci_0 = c0[1];
    r.cw_0 = c0[4];
    return r;
  }
};

// 4-byte words of a StagedRows block.
__host__ __device__ inline int staged_words(int Lmax) { return 2 * Lmax + 5 * (Lmax + 1); }

// The group's lanes (``gl`` of ``G``) stage the rows of a path of depth d.
__device__ __forceinline__ StagedRows stage_rows(const TypedCore& a, int32_t* mem, int f, int d,
                                                 int gl, int G) {
  StagedRows s;
  int32_t* cls = mem;
  float* ceil = reinterpret_cast<float*>(mem + a.Lmax);
  int32_t* caps = mem + 2 * a.Lmax;
  const int32_t* pcls = a.path_cls + (long long)f * a.Lmax;
  const int32_t* pnode = a.path_node + (long long)f * a.Lmax;
  for (int r = gl; r < d; r += G) {
    cls[r] = __ldg(pcls + r);
    const int pn = __ldg(pnode + r);
    ceil[r] = __ldg(a.node_ceil + pn);
#pragma unroll
    for (int q = 0; q < 5; ++q) caps[5 * (r + 1) + q] = __ldg(a.node_caps + 5ll * pn + q);
  }
  if (gl < 5) caps[gl] = __ldg(a.root_caps + gl);
  s.cls = cls;
  s.ceil = ceil;
  s.caps = caps;
  return s;
}

// Shared memory of typed_dp_warp, in 4-byte words: five rows of B x nch
// cells and the candidate's haystack window.
__host__ __device__ inline int warp_words(int E, int nch, int Lmax) {
  return 5 * (2 * E + 1) * nch + Lmax + 2 * E + 1;
}

inline size_t smem_bytes(int E, int nch, int Lmax) {
  return sizeof(int32_t) * ((size_t)nch * GCOLS + (size_t)TY_WARPS * warp_words(E, nch, Lmax));
}

// Every thread of the block calls this before any of them leaves.
__device__ __forceinline__ void load_graph(const TypedCore& a, int32_t* g, int nthreads) {
  for (int t = threadIdx.x; t < a.nch * GCOLS; t += nthreads) g[t] = __ldg(a.graph + t);
}

// The DP of one candidate (depth d, start s), run by the 32 lanes of a warp
// over ``mem`` (warp_words() words of shared memory), the path's row values
// from ``rows``. Returns the emission channel at row d, [B][nch] in shared
// memory (+inf where dead); the caller __syncwarp()s before the memory is
// used again.
template <typename Rows>
__device__ const float* typed_dp_warp(const TypedCore& a, const int32_t* g, int32_t* mem,
                                      int d, long long s, int lane, const Rows& rows) {
  const int E = a.E, B = 2 * E + 1, nch = a.nch, cells = B * nch;
  const float INF = __int_as_float(0x7f800000);
  float* prev2 = reinterpret_cast<float*>(mem);  // row i-2
  float* prev = prev2 + cells;                   // row i-1
  float* nw = prev + cells;                      // row i
  float* preve = nw + cells;                     // emission channel of row i-1
  float* newe = preve + cells;                   // emission channel of row i
  int32_t* win = mem + 5 * cells;                // win[o] = hay(s + o - E - 1)
  const float max_pen = a.max_pen;

  for (int t = lane; t < d + 2 * E + 1; t += 32) win[t] = hay_at(a, s - E - 1 + t);
  for (int c = lane; c < cells; c += 32) {
    // Row 0 is the origin (band E, the zero vector); row -1 is dead.
    const float origin = c == E * nch ? 0.f : INF;
    prev2[c] = INF;
    prev[c] = origin;
    preve[c] = origin;
  }
  __syncwarp();

  for (int i = 1; i <= d; ++i) {
    const RowVals r = rows(i);
    const int pc = r.pc, pc_prev = r.pc_prev;
    const float ceil_i = r.ceil_i;

    // Every cell's arrivals but the insertion, and the emission channel.
    for (int c = lane; c < cells; c += 32) {
      const int b = c / nch, ch = c - b * nch;
      const int j = i + b - E;  // haystack symbols consumed at this cell
      const int hc = win[i + b], hc_jm1 = win[i - 1 + b];
      float sim = 0.f;
      if (hc >= 0) sim = __ldg(a.sim + pc * a.C + hc);
      const float spen = __fmul_rn(a.p_sub, __fsub_rn(1.f, sim));
      const int32_t* gr = g + ch * GCOLS;
      // exact: (i-1, b, ch), no edit
      const float p = prev[c];
      float bp = (j >= 1 && fin(p) && hc == pc) ? p : INF;
      int src = gr[G_SUB];
      if (src >= 0) {
        // substitution: (i-1, b, src), caps of row i-1
        const int32_t* gs = g + src * GCOLS;
        const float q = prev[b * nch + src];
        const bool ok = j >= 1 && fin(q) && hc >= 0 && hc != pc && !(sim < a.floor_) &&
                        !(spen > __fsub_rn(max_pen, q)) && gs[G_SUM] < r.ce_1 &&
                        gs[G_NS] < r.cs_1;
        const float v = __fadd_rn(q, spen);
        if (ok && v < bp) bp = v;
      }
      src = gr[G_SWAP];
      if (src >= 0) {
        // swap: (i-2, b, src), caps of row i
        const int32_t* gs = g + src * GCOLS;
        const float sw = prev2[b * nch + src];
        const bool ok = i >= 2 && j >= 2 && fin(sw) &&
                        !(a.p_swap > __fsub_rn(max_pen, sw)) && hc >= 0 && hc_jm1 >= 0 &&
                        hc == pc_prev && hc_jm1 == pc && gs[G_SUM] < r.ce_0 &&
                        gs[G_NW] < r.cw_0;
        const float v = __fadd_rn(sw, a.p_swap);
        if (ok && v < bp) bp = v;
      }
      float ep = bp;  // the consuming arrivals
      src = gr[G_DEL];
      if (src >= 0 && b + 1 < B) {
        const int32_t* gs = g + src * GCOLS;
        if (gs[G_SUM] < r.ce_1 && gs[G_ND] < r.cd_1) {
          // deletion: (i-1, b+1, src), consumes pc only, caps of row i-1
          const float dl = prev[(b + 1) * nch + src];
          const float v = __fadd_rn(dl, a.p_del);
          if (fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl)) && v < bp) bp = v;
          // the emission channel's trailing deletion, from its row i-1
          const float t = preve[(b + 1) * nch + src];
          const float vt = __fadd_rn(t, a.p_del);
          if (fin(t) && !(a.p_del > __fsub_rn(max_pen, t)) && vt < ep) ep = vt;
        }
      }
      nw[c] = bp;
      newe[c] = ep > ceil_i ? INF : ep;
    }
    __syncwarp();

    // insertion: same row, (b-1, src) -> (b, ch), ascending b over the
    // updated band b-1; none from cells with zero hay consumed; caps of row i.
    for (int b = 1; b < B; ++b) {
      if (i + b - E >= 2 && win[i + b] >= 0) {
        for (int ch = lane; ch < nch; ch += 32) {
          const int src = g[ch * GCOLS + G_INS];
          if (src < 0) continue;
          const int32_t* gs = g + src * GCOLS;
          const float ip = nw[(b - 1) * nch + src];
          const bool ok = fin(ip) && !(a.p_ins > __fsub_rn(max_pen, ip)) &&
                          gs[G_SUM] < r.ce_0 && gs[G_NI] < r.ci_0;
          const float v = __fadd_rn(ip, a.p_ins);
          if (ok && v < nw[b * nch + ch]) nw[b * nch + ch] = v;
        }
      }
      __syncwarp();
    }

    // Ceiling of the continuation channel, then the rows move up.
    for (int c = lane; c < cells; c += 32)
      if (nw[c] > ceil_i) nw[c] = INF;
    __syncwarp();
    float* t = prev2;
    prev2 = prev;
    prev = nw;
    nw = t;
    t = preve;
    preve = newe;
    newe = t;
  }
  return preve;  // the emission channel of row d
}

// The same DP with one cell per lane in registers: lane gl < B * nch of a
// group of G lanes (mask ``gm``) holds cell gl = b * nch + ch; arrivals are
// shuffles from the source cell's lane. ``win`` is the staged window
// (win[o] = hay(s + o - E - 1)). Writes the emission channel at row d to
// ebuf[gl] (+inf where dead) and syncs the group.
template <int G>
__device__ void typed_dp_lanes(const TypedCore& a, const int32_t* g, const int32_t* win,
                               const StagedRows& rows, int d, int gl, unsigned gm, float* ebuf) {
  const int E = a.E, B = 2 * E + 1, nch = a.nch;
  const float INF = __int_as_float(0x7f800000);
  const float max_pen = a.max_pen;
  const bool mine = gl < B * nch;
  const int b = mine ? gl / nch : 0, ch = mine ? gl - (gl / nch) * nch : 0;
  const int32_t* gr = g + ch * GCOLS;
  // Each arrival's source lane (the lane itself where there is none) and
  // the source channel's edit total and count of the arrival's type.
  const int s_sub = mine ? gr[G_SUB] : -1, s_swap = mine ? gr[G_SWAP] : -1;
  const int s_del = (mine && b + 1 < B) ? gr[G_DEL] : -1;
  const int s_ins = (mine && b >= 1) ? gr[G_INS] : -1;
  const int l_sub = s_sub >= 0 ? b * nch + s_sub : gl;
  const int l_swap = s_swap >= 0 ? b * nch + s_swap : gl;
  const int l_del = s_del >= 0 ? (b + 1) * nch + s_del : gl;
  const int l_ins = s_ins >= 0 ? (b - 1) * nch + s_ins : gl;
  const int sub_sum = s_sub >= 0 ? g[s_sub * GCOLS + G_SUM] : 0;
  const int sub_ns = s_sub >= 0 ? g[s_sub * GCOLS + G_NS] : 0;
  const int swap_sum = s_swap >= 0 ? g[s_swap * GCOLS + G_SUM] : 0;
  const int swap_nw = s_swap >= 0 ? g[s_swap * GCOLS + G_NW] : 0;
  const int del_sum = s_del >= 0 ? g[s_del * GCOLS + G_SUM] : 0;
  const int del_nd = s_del >= 0 ? g[s_del * GCOLS + G_ND] : 0;
  const int ins_sum = s_ins >= 0 ? g[s_ins * GCOLS + G_SUM] : 0;
  const int ins_ni = s_ins >= 0 ? g[s_ins * GCOLS + G_NI] : 0;

  // Row 0 is the origin (band E, the zero vector); row -1 is dead.
  float prev2 = INF;
  float prev = (mine && gl == E * nch) ? 0.f : INF;
  float preve = prev;
  for (int i = 1; i <= d; ++i) {
    const RowVals r = rows(i);
    const int j = i + b - E;  // haystack symbols consumed at this cell
    const int hc = win[i + b], hc_jm1 = win[i - 1 + b];
    float sim = 0.f;
    if (hc >= 0) sim = __ldg(a.sim + r.pc * a.C + hc);
    const float spen = __fmul_rn(a.p_sub, __fsub_rn(1.f, sim));
    const float q = __shfl_sync(gm, prev, l_sub, G);
    const float sw = __shfl_sync(gm, prev2, l_swap, G);
    const float dl = __shfl_sync(gm, prev, l_del, G);
    const float te = __shfl_sync(gm, preve, l_del, G);
    // exact: (i-1, b, ch), no edit
    float bp = (j >= 1 && fin(prev) && hc == r.pc) ? prev : INF;
    if (s_sub >= 0) {
      // substitution: (i-1, b, src), caps of row i-1
      const bool ok = j >= 1 && fin(q) && hc >= 0 && hc != r.pc && !(sim < a.floor_) &&
                      !(spen > __fsub_rn(max_pen, q)) && sub_sum < r.ce_1 && sub_ns < r.cs_1;
      const float v = __fadd_rn(q, spen);
      if (ok && v < bp) bp = v;
    }
    if (s_swap >= 0) {
      // swap: (i-2, b, src), caps of row i
      const bool ok = i >= 2 && j >= 2 && fin(sw) && !(a.p_swap > __fsub_rn(max_pen, sw)) &&
                      hc >= 0 && hc_jm1 >= 0 && hc == r.pc_prev && hc_jm1 == r.pc &&
                      swap_sum < r.ce_0 && swap_nw < r.cw_0;
      const float v = __fadd_rn(sw, a.p_swap);
      if (ok && v < bp) bp = v;
    }
    float ep = bp;  // the consuming arrivals
    if (s_del >= 0 && del_sum < r.ce_1 && del_nd < r.cd_1) {
      // deletion: (i-1, b+1, src), consumes pc only, caps of row i-1
      const float v = __fadd_rn(dl, a.p_del);
      if (fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl)) && v < bp) bp = v;
      // the emission channel's trailing deletion, from its row i-1
      const float vt = __fadd_rn(te, a.p_del);
      if (fin(te) && !(a.p_del > __fsub_rn(max_pen, te)) && vt < ep) ep = vt;
    }
    float nw = bp;
    const float newe = ep > r.ceil_i ? INF : ep;
    // insertion: same row, (b-1, src) -> (b, ch), ascending b over the
    // updated band b-1; none from cells with zero hay consumed; caps of row i.
    for (int bb = 1; bb < B; ++bb) {
      const float ip = __shfl_sync(gm, nw, l_ins, G);
      if (b == bb && s_ins >= 0 && i + bb - E >= 2 && win[i + bb] >= 0) {
        const bool ok = fin(ip) && !(a.p_ins > __fsub_rn(max_pen, ip)) && ins_sum < r.ce_0 &&
                        ins_ni < r.ci_0;
        const float v = __fadd_rn(ip, a.p_ins);
        if (ok && v < nw) nw = v;
      }
    }
    // Ceiling of the continuation channel, then the rows move up.
    if (nw > r.ceil_i) nw = INF;
    prev2 = prev;
    prev = nw;
    preve = newe;
  }
  if (mine) ebuf[gl] = preve;
  __syncwarp(gm);
}

struct TypedDpArgs {
  TypedCore core;
  const int32_t* cand_field;  // [M], -1 = dead slot
  const int32_t* cand_start;  // [M]
  long long M;
  float* pen_out;             // [B * nch, M]
};

__global__ void __launch_bounds__(TY_THREADS) banded_dp_typed_kernel(TypedDpArgs a) {
  extern __shared__ int32_t s_mem[];
  load_graph(a.core, s_mem, TY_THREADS);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * TY_WARPS + warp;
  if (m >= a.M) return;
  const int cells = (2 * a.core.E + 1) * a.core.nch;
  int32_t* mem = s_mem + a.core.nch * GCOLS +
                 warp * warp_words(a.core.E, a.core.nch, a.core.Lmax);
  const int f = __ldg(a.cand_field + m);
  const float* emit = nullptr;
  if (f >= 0) {
    const GlobalRows rows{&a.core, a.core.path_cls + (long long)f * a.core.Lmax,
                          a.core.path_node + (long long)f * a.core.Lmax};
    emit = typed_dp_warp(a.core, s_mem, mem, __ldg(a.core.depth + f), __ldg(a.cand_start + m),
                         lane, rows);
  }
  for (int c = lane; c < cells; c += 32)
    a.pen_out[(long long)c * a.M + m] = emit ? emit[c] : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// The step of one slice: expansion, DP over the list, emission.
// ---------------------------------------------------------------------------

struct TypedExpandArgs {
  const long long* pos;     // [K] ascending hit positions
  const long long* words;   // [K, W2] u32 halves of the match words
  long long K;
  long long h0;             // first hit expanded; hits before it only feed the dedup
  int W2;
  const int32_t* combos;    // [5, n_combo]: word column, bit, field, start offset, b == 0
  int n_combo;
  long long start_lo, start_hi, pos_hi;
  long long nblk;           // blocks of TE_TILE items
  unsigned long long* status;  // lookback.cuh's array, nblk tiles
  unsigned epoch;
  unsigned long long base;
  int32_t* cand_field;      // [items] (the first *total are written)
  int32_t* cand_start;
  int32_t* cand_combo;
  int32_t* total;           // [1] the candidates' total, by the last block
};

// The t-th block to take a ticket expands the tile of items t * TE_TILE ..,
// item row r of it (TE_THREADS items) by threads 0..TE_THREADS-1: item g =
// c * (K - h0) + h - h0, dp_pipeline.cu's expansion test, a candidate or
// none. Its candidates follow those of blocks 0..t-1 (a ballot per item
// row and warp, a scan of those counts in (row, warp) order, the look-back
// across blocks), so the list is in item order; the last block writes the
// total.
__global__ void __launch_bounds__(TE_THREADS) typed_expand_kernel(TypedExpandArgs a) {
  __shared__ int s_cnt[TE_SLOTS];
  __shared__ int s_first[TE_WARPS], s_part[TE_WARPS];
  __shared__ long long s_t;
  __shared__ int s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = lookback::take_tile(a.status, a.base, &s_t);
  // Items fit int32 (the caller checked): 32-bit division.
  const unsigned KI = (unsigned)(a.K - a.h0), n_items = KI * (unsigned)a.n_combo;
  unsigned bal[TE_ITEMS];
  int cf[TE_ITEMS], cs[TE_ITEMS], cc[TE_ITEMS];
#pragma unroll
  for (int r = 0; r < TE_ITEMS; ++r) {
    const long long gl = t * TE_TILE + (long long)r * TE_THREADS + threadIdx.x;
    bool alive = false;
    cf[r] = cs[r] = cc[r] = 0;
    if (gl < n_items) {
      const unsigned gi = (unsigned)gl;
      const int c = (int)(gi / KI);
      const long long h = a.h0 + (gi - (unsigned)c * KI);
      const int col = __ldg(a.combos + c);
      const int sh = __ldg(a.combos + a.n_combo + c);
      const long long p = __ldg(a.pos + h);
      const bool fired = ((__ldg(a.words + h * a.W2 + col) >> sh) & 1) != 0;
      bool dup = false;
      if (h > 0 && __ldg(a.pos + h - 1) + 1 == p)
        dup = ((__ldg(a.words + (h - 1) * a.W2 + col) >> sh) & 1) != 0;
      const long long s = p + 1 - __ldg(a.combos + 3 * a.n_combo + c);
      alive = fired && p >= 0 && p < a.pos_hi && s >= a.start_lo && s < a.start_hi &&
              (__ldg(a.combos + 4 * a.n_combo + c) != 0 || !dup);
      cf[r] = __ldg(a.combos + 2 * a.n_combo + c);
      cs[r] = (int32_t)s;
      cc[r] = c;
    }
    bal[r] = __ballot_sync(0xFFFFFFFFu, alive);
    if (lane == 0) s_cnt[r * TE_WARPS + warp] = __popc(bal[r]);
  }
  __syncthreads();
  if (warp == 0) {
    // Lane l scans slots l * TE_PER_LANE .. in order, then the lanes.
    int v[TE_PER_LANE], w = 0;
#pragma unroll
    for (int q = 0; q < TE_PER_LANE; ++q) {
      const int k = lane * TE_PER_LANE + q;
      v[q] = k < TE_SLOTS ? s_cnt[k] : 0;
      w += v[q];
    }
    int incl = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += up;
    }
    int run = incl - w;
#pragma unroll
    for (int q = 0; q < TE_PER_LANE; ++q) {
      const int k = lane * TE_PER_LANE + q;
      if (k < TE_SLOTS) s_cnt[k] = run;  // candidates of the slots before
      run += v[q];
    }
    if (lane == 31) {
      s_count = incl;
      lookback::publish(a.status, a.epoch, t, t == 0, incl);
    }
  }
  __syncthreads();
  const int count = s_count;
  const int before =
      t == 0 ? 0 : lookback::look_back<TE_THREADS>(a.status, a.epoch, t, s_first, s_part);
  if (threadIdx.x == 0) {
    if (t > 0) lookback::publish(a.status, a.epoch, t, true, before + count);
    if (t == a.nblk - 1) *a.total = before + count;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < TE_ITEMS; ++r) {
    if (!((bal[r] >> lane) & 1)) continue;
    const int at = before + s_cnt[r * TE_WARPS + warp] + __popc(bal[r] & below);
    a.cand_field[at] = cf[r];
    a.cand_start[at] = cs[r];
    a.cand_combo[at] = cc[r];
  }
}

struct TypedListArgs {
  TypedCore core;
  const int32_t* cand_field;  // [items] the candidate list, n_cand of them
  const int32_t* cand_start;
  const int32_t* n_cand;      // on the card: the expansion's total
  long long items;            // the list's bound, dec's row stride
  const int32_t* node;        // [F] output node of each field
  const int32_t* out_list;    // [N, MO] patterns of each node, -1 padded
  int MO;
  const float* pat_len;       // [P]
  const float* pat_weight;    // [P]
  float bound;                // threshold less the emission slack
  const int32_t* limcls;      // [P] limits class of each pattern
  const int32_t* adm;         // [NLC, nch] whether a class admits a channel
  int2* dec;                  // [nce, items]: (penalty bits, channel), channel -1 = no row
  // [nce * ntile + nce + 2]: rows per (channel, tile) channel-major, rows
  // per channel, the rows' total, the candidates' total (dp_list.cu's layout)
  int32_t* row_counts;
  long long ntile;
};

// The row counts' words after the tiles': the channels' totals from here,
// then the rows' total and the candidates' total.
__device__ __forceinline__ long long channel_totals(const TypedListArgs& a, int nce) {
  return (long long)nce * a.ntile;
}

// What emission channel ce = (band, slot) of a candidate (field f, depth d,
// start, output node ``node``) decides from the emission channel ``emit``
// [B][nch] (shared memory): the strict-< minimum, channels ascending (the
// fewest edits win penalty ties), over the channels the pattern's limits
// class admits, and the span and similarity tests; (0, -1) for no row.
__device__ __forceinline__ int2 typed_decision(const TypedListArgs& a, const float* emit,
                                               int node, int d, int start, int ce) {
  const int E = a.core.E, nch = a.core.nch;
  const int b = ce / a.MO, o = ce - b * a.MO;
  const int pat = __ldg(a.out_list + (long long)node * a.MO + o);
  const int ends_b = start + d + (b - E);
  if (pat < 0 || ends_b > a.core.limit || ends_b < start) return make_int2(0, -1);
  const int32_t* ad = a.adm + (long long)__ldg(a.limcls + pat) * nch;
  float best = __int_as_float(0x7f800000);
  int bch = 0;
  for (int ch = 0; ch < nch; ++ch) {
    const float v = emit[b * nch + ch];
    if (__ldg(ad + ch) != 0 && v < best) {
      best = v;
      bch = ch;
    }
  }
  if (!fin(best)) return make_int2(0, -1);
  const float pl = __ldg(a.pat_len + pat);
  const float sim = __fmul_rn(__fdiv_rn(__fsub_rn(pl, best), pl), __ldg(a.pat_weight + pat));
  return sim >= a.bound ? make_int2(__float_as_int(best), bch) : make_int2(0, -1);
}

// Per emission channel ce = (band, slot) of candidate m, the lanes of its
// group (gl of G) decide the row and count it in s_cnt.
__device__ __forceinline__ void typed_decide(const TypedListArgs& a, const float* emit, int f,
                                             int d, int start, long long m, int gl, int G,
                                             int* s_cnt) {
  const int nce = (2 * a.core.E + 1) * a.MO;
  const int node = __ldg(a.node + f);
  for (int ce = gl; ce < nce; ce += G) {
    const int2 out = typed_decision(a, emit, node, d, start, ce);
    if (out.y >= 0) atomicAdd(s_cnt + ce, 1);
    a.dec[(long long)ce * a.items + m] = out;
  }
}

// Adds ``rows`` of each lane of the warp to the rows' total: one atomic a
// warp (every lane of the warp calls it).
__device__ __forceinline__ void add_rows(const TypedListArgs& a, int nce, int rows) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rows += __shfl_xor_sync(0xFFFFFFFFu, rows, o);
  if ((threadIdx.x & 31) == 0 && rows != 0)
    atomicAdd(a.row_counts + channel_totals(a, nce) + nce, rows);
}

// The block's row counts into row_counts: its tile's, the channels' and
// the rows' total (every thread calls it).
__device__ __forceinline__ void flush_counts(const TypedListArgs& a, const int* s_cnt,
                                             long long first) {
  __syncthreads();
  const int nce = (2 * a.core.E + 1) * a.MO;
  int rows = 0;
  if ((int)threadIdx.x < nce && s_cnt[threadIdx.x] != 0) {
    rows = s_cnt[threadIdx.x];
    atomicAdd(a.row_counts + (long long)threadIdx.x * a.ntile + first / TYPED_TILE, rows);
    atomicAdd(a.row_counts + channel_totals(a, nce) + threadIdx.x, rows);
  }
  add_rows(a, nce, rows);
}

// Shared memory of a block of typed_dp_kernel<G>, in 4-byte words: the
// graph, the block's row counts, then per group its staged rows, the
// window and G emission cells.
__host__ __device__ inline int list_group_words(int G, int E, int Lmax) {
  return staged_words(Lmax) + Lmax + 2 * E + 1 + G;
}

inline size_t list_smem_bytes(int G, int E, int nch, int Lmax) {
  return sizeof(int32_t) * ((size_t)nch * GCOLS + MAX_CHANNELS +
                            (size_t)(TD_THREADS / G) * list_group_words(G, E, Lmax));
}

// Block start: the first candidate of the block, the candidate total; every
// block that holds a candidate loads the graph and zeroes its counts.
// Returns false where the block holds none.
__device__ __forceinline__ bool list_block_start(const TypedListArgs& a, int32_t* s_mem,
                                                 int groups, int nthreads, long long& first,
                                                 int& n_cand) {
  const int nce = (2 * a.core.E + 1) * a.MO;
  n_cand = __ldg(a.n_cand);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.row_counts[channel_totals(a, nce) + nce + 1] = n_cand;
  first = (long long)blockIdx.x * groups;
  if (first >= n_cand) return false;
  load_graph(a.core, s_mem, nthreads);
  int* s_cnt = s_mem + a.core.nch * GCOLS;
  for (int t = threadIdx.x; t < nce; t += nthreads) s_cnt[t] = 0;
  __syncthreads();
  return true;
}

// The DP over the list with one cell per lane: a group of G lanes per
// candidate (B x nch <= G).
template <int G>
__global__ void __launch_bounds__(TD_THREADS) typed_dp_kernel(TypedListArgs a) {
  extern __shared__ int32_t s_mem[];
  constexpr int GROUPS = TD_THREADS / G;
  long long first;
  int n_cand;
  if (!list_block_start(a, s_mem, GROUPS, TD_THREADS, first, n_cand)) return;
  const TypedCore& core = a.core;
  int* s_cnt = s_mem + core.nch * GCOLS;
  const int grp = threadIdx.x / G, gl = threadIdx.x % G;
  const long long m = first + grp;
  if (m < n_cand) {
    const unsigned gm =
        G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
    int32_t* mem = s_mem + core.nch * GCOLS + MAX_CHANNELS +
                   grp * list_group_words(G, core.E, core.Lmax);
    const int f = __ldg(a.cand_field + m);
    const int start = __ldg(a.cand_start + m);
    const int d = __ldg(core.depth + f);
    const StagedRows rows = stage_rows(core, mem, f, d, gl, G);
    int32_t* win = mem + staged_words(core.Lmax);
    float* ebuf = reinterpret_cast<float*>(win + core.Lmax + 2 * core.E + 1);
    for (int t = gl; t < d + 2 * core.E + 1; t += G) win[t] = hay_at(core, start - core.E - 1 + t);
    __syncwarp(gm);
    typed_dp_lanes<G>(core, s_mem, win, rows, d, gl, gm, ebuf);
    typed_decide(a, ebuf, f, d, start, m, gl, G, s_cnt);
  }
  flush_counts(a, s_cnt, first);
}

// ---------------------------------------------------------------------------
// The DP over the list past 32 cells: a channel per lane and slot, the bands
// in registers.
// ---------------------------------------------------------------------------

// The arrivals into one channel slot of a lane, by type (T_SUB, T_SWAP,
// T_DEL, T_INS): the source channel's lane in the group and slot, lane |
// slot << 5 (the lane itself where there is none), and the source's edit
// total and count of the arrival's type, which the caps of a row test
// (a total no cap passes where there is no source).
constexpr int T_SUB = 0, T_SWAP = 1, T_DEL = 2, T_INS = 3;
constexpr int NO_SOURCE = 1 << 30;
struct Arrival {
  int src, sum, cnt;
};

template <int G>
__device__ __forceinline__ Arrival arrival_of(const TypedCore& a, int ch, int col, int cnt_col,
                                              int gl, int s) {
  const int src = ch < a.nch ? __ldg(a.graph + ch * GCOLS + col) : -1;
  Arrival x;
  x.src = src >= 0 ? (src % G) | (src / G) << 5 : gl | s << 5;
  x.sum = src >= 0 ? __ldg(a.graph + src * GCOLS + G_SUM) : NO_SOURCE;
  x.cnt = src >= 0 ? __ldg(a.graph + src * GCOLS + cnt_col) : 0;
  return x;
}

// Band b of the arrival's source channel in ``x`` [slot][band]: a shuffle
// from the source's lane per slot, the source's slot kept.
template <int S, int B, int G>
__device__ __forceinline__ float source_band(unsigned gm, const float (&x)[S][B], int b,
                                             const Arrival& ar) {
  const int lane = ar.src & 31;
  float v = __shfl_sync(gm, x[0][b], lane, G);
#pragma unroll
  for (int k = 1; k < S; ++k) {
    const float t = __shfl_sync(gm, x[k][b], lane, G);
    if ((ar.src >> 5) == k) v = t;
  }
  return v;
}

// The DP of one candidate (depth d) over its group's G lanes (mask gm):
// channel s * G + gl in slot s of lane gl; ``ar`` the slots' arrivals,
// ``rows`` the staged path rows, ``win`` the staged window (win[o] =
// hay(s + o - E - 1)). Returns the emission channel of row d in ``out``
// [slot][band] (+inf where dead) and whether any of the group's is finite.
// The recurrences, guards, merges and f32 order are typed_dp_warp's.
template <int E, int S, int G>
__device__ __forceinline__ bool typed_dp_slots(const TypedCore& a, const Arrival (&ar)[S][4],
                                               const StagedRows& rows, const int32_t* win,
                                               int d, int gl, unsigned gm,
                                               float (&PE)[S][2 * E + 1]) {
  constexpr int B = 2 * E + 1;
  const float INF = __int_as_float(0x7f800000);
  const float max_pen = a.max_pen;
  float P1[S][B], P2[S][B];  // rows i-1 and i-2
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int b = 0; b < B; ++b) P1[s][b] = P2[s][b] = PE[s][b] = INF;
  // Row 0 is the origin (band E, the zero vector: channel 0); row -1 is dead.
  if (gl == 0) P1[0][E] = PE[0][E] = 0.f;
  // The band symbols of row i: w[b + 1] = win[i + b] (band b consumes it),
  // w[b] = win[i - 1 + b] (the symbol before).
  int w[B + 1];
#pragma unroll
  for (int k = 0; k <= B; ++k) w[k] = win[k];
#pragma unroll 1
  for (int i = 1; i <= d; ++i) {
    const RowVals r = rows(i);
    bool c_sub[S], c_swap[S], c_del[S], c_ins[S];  // the caps the arrivals pass
#pragma unroll
    for (int s = 0; s < S; ++s) {
      c_sub[s] = ar[s][T_SUB].sum < r.ce_1 && ar[s][T_SUB].cnt < r.cs_1;
      c_swap[s] = ar[s][T_SWAP].sum < r.ce_0 && ar[s][T_SWAP].cnt < r.cw_0;
      c_del[s] = ar[s][T_DEL].sum < r.ce_1 && ar[s][T_DEL].cnt < r.cd_1;
      c_ins[s] = ar[s][T_INS].sum < r.ce_0 && ar[s][T_INS].cnt < r.ci_0;
    }
    // Every cell's arrivals but the insertion, and the emission channel,
    // band by band: band b reads the emission channel of row i-1 at band
    // b+1, which it replaces only after band b-1 has read it.
    float N[S][B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = i + b - E;  // haystack symbols consumed at this band
      const int hc = w[b + 1], hc_jm1 = w[b];
      float sim = 0.f;
      if (hc >= 0) sim = __ldg(a.sim + r.pc * a.C + hc);
      const float spen = __fmul_rn(a.p_sub, __fsub_rn(1.f, sim));
      const bool sub_band = j >= 1 && hc >= 0 && hc != r.pc && !(sim < a.floor_);
      const bool swap_band = i >= 2 && j >= 2 && hc >= 0 && hc_jm1 >= 0 && hc == r.pc_prev &&
                             hc_jm1 == r.pc;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        // exact: (i-1, b, ch), no edit
        const float p = P1[s][b];
        float bp = (j >= 1 && fin(p) && hc == r.pc) ? p : INF;
        // substitution: (i-1, b, src), caps of row i-1
        const float q = source_band<S, B, G>(gm, P1, b, ar[s][T_SUB]);
        if (c_sub[s] && sub_band && fin(q) && !(spen > __fsub_rn(max_pen, q))) {
          const float v = __fadd_rn(q, spen);
          if (v < bp) bp = v;
        }
        // swap: (i-2, b, src), caps of row i
        const float sw = source_band<S, B, G>(gm, P2, b, ar[s][T_SWAP]);
        if (c_swap[s] && swap_band && fin(sw) && !(a.p_swap > __fsub_rn(max_pen, sw))) {
          const float v = __fadd_rn(sw, a.p_swap);
          if (v < bp) bp = v;
        }
        float ep = bp;  // the consuming arrivals
        if (b + 1 < B) {
          // deletion: (i-1, b+1, src), consumes pc only, caps of row i-1;
          // the emission channel's trailing deletion, from its row i-1
          const float dl = source_band<S, B, G>(gm, P1, b + 1, ar[s][T_DEL]);
          const float te = source_band<S, B, G>(gm, PE, b + 1, ar[s][T_DEL]);
          if (c_del[s]) {
            const float v = __fadd_rn(dl, a.p_del);
            if (fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl)) && v < bp) bp = v;
            const float vt = __fadd_rn(te, a.p_del);
            if (fin(te) && !(a.p_del > __fsub_rn(max_pen, te)) && vt < ep) ep = vt;
          }
        }
        N[s][b] = bp;
        PE[s][b] = ep > r.ceil_i ? INF : ep;
      }
    }
    // insertion: same row, (b-1, src) -> (b, ch), ascending b over the
    // updated band b-1; none from cells with zero hay consumed; caps of row i.
#pragma unroll
    for (int b = 1; b < B; ++b) {
      const bool ins_band = i + b - E >= 2 && w[b + 1] >= 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float ip = source_band<S, B, G>(gm, N, b - 1, ar[s][T_INS]);
        if (ins_band && c_ins[s] && fin(ip) && !(a.p_ins > __fsub_rn(max_pen, ip))) {
          const float v = __fadd_rn(ip, a.p_ins);
          if (v < N[s][b]) N[s][b] = v;
        }
      }
    }
    // Ceiling of the continuation channel, then the rows move up.
    float lo = INF;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int b = 0; b < B; ++b) {
        P2[s][b] = P1[s][b];
        P1[s][b] = N[s][b] > r.ceil_i ? INF : N[s][b];
        lo = fminf(lo, fminf(fminf(P1[s][b], P2[s][b]), PE[s][b]));
      }
#pragma unroll
    for (int k = 0; k < B; ++k) w[k] = w[k + 1];
    w[B] = i < d ? win[i + B] : -1;
    // Where no value that a later row reads is finite (rows i and i-1, the
    // emission channel of row i), no later cell is, nor the emission at row
    // d: the group stops. Penalties are finite or +inf, never NaN.
    if (!__any_sync(gm, lo < INF)) return false;
  }
  float lo = INF;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int b = 0; b < B; ++b) lo = fminf(lo, PE[s][b]);
  return __any_sync(gm, lo < INF);
}

// Shared memory of a group of typed_dp_rows_kernel, in 4-byte words: its
// staged rows, the window and the emission channel [B][nch].
__host__ __device__ inline int rows_group_words(int E, int nch, int Lmax) {
  return staged_words(Lmax) + Lmax + 2 * E + 1 + (2 * E + 1) * nch;
}

// The DP over the list past 32 cells: a group of G lanes per candidate, S
// channel slots a lane, their bands in registers (typed_dp_slots).
// The groups of a capped grid (TR_WAVES times the card's resident blocks)
// stride over the list on their own, with no block barrier: a group whose
// candidate dies early takes its next one at once; its rows go to their
// tiles' and channels' counts by atomics.
template <int E, int S, int G>
__global__ void __launch_bounds__(TR_THREADS) typed_dp_rows_kernel(TypedListArgs a) {
  extern __shared__ int32_t s_mem[];
  constexpr int GROUPS = TR_THREADS / G, B = 2 * E + 1;
  const TypedCore& core = a.core;
  const int nce = B * a.MO;
  const int n_cand = __ldg(a.n_cand);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.row_counts[channel_totals(a, nce) + nce + 1] = n_cand;
  if ((long long)blockIdx.x * GROUPS >= n_cand) return;
  const int grp = threadIdx.x / G, gl = threadIdx.x % G;
  const unsigned gm = G == 32 ? 0xFFFFFFFFu : 0xFFFFu << (threadIdx.x & 31 & ~(G - 1));
  int32_t* mem = s_mem + grp * rows_group_words(E, core.nch, core.Lmax);
  int32_t* win = mem + staged_words(core.Lmax);
  float* ebuf = reinterpret_cast<float*>(win + core.Lmax + 2 * E + 1);
  Arrival ar[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int ch = s * G + gl;
    ar[s][T_SUB] = arrival_of<G>(core, ch, G_SUB, G_NS, gl, s);
    ar[s][T_SWAP] = arrival_of<G>(core, ch, G_SWAP, G_NW, gl, s);
    ar[s][T_DEL] = arrival_of<G>(core, ch, G_DEL, G_ND, gl, s);
    ar[s][T_INS] = arrival_of<G>(core, ch, G_INS, G_NI, gl, s);
  }
  const long long stride = (long long)gridDim.x * GROUPS;
  int rows = 0;  // this lane's rows over its group's candidates
  for (long long m = (long long)blockIdx.x * GROUPS + grp; m < n_cand; m += stride) {
    const int f = __ldg(a.cand_field + m);
    const int start = __ldg(a.cand_start + m);
    const int d = __ldg(core.depth + f);
    const StagedRows staged = stage_rows(core, mem, f, d, gl, G);
    for (int t = gl; t < d + 2 * E + 1; t += G) win[t] = hay_at(core, start - E - 1 + t);
    __syncwarp(gm);
    float pe[S][B];
    const bool any = typed_dp_slots<E, S, G>(core, ar, staged, win, d, gl, gm, pe);
    if (any) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s * G + gl < core.nch)
#pragma unroll
          for (int b = 0; b < B; ++b) ebuf[b * core.nch + s * G + gl] = pe[s][b];
      __syncwarp(gm);
    }
    const int node = __ldg(a.node + f);
    for (int ce = gl; ce < nce; ce += G) {
      const int2 out = any ? typed_decision(a, ebuf, node, d, start, ce) : make_int2(0, -1);
      if (out.y >= 0) {
        atomicAdd(a.row_counts + (long long)ce * a.ntile + m / TYPED_TILE, 1);
        atomicAdd(a.row_counts + channel_totals(a, nce) + ce, 1);
        ++rows;
      }
      a.dec[(long long)ce * a.items + m] = out;
    }
    __syncwarp(gm);  // the group's memory is staged again
  }
  add_rows(a, nce, rows);  // the warp's groups have all left the loop
}

// Kernels whose shared memory passes 48 KiB must be allowed it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool fill_core(TypedCore& c, const void* ids, int ids_u8, long long npad, long long limit,
               const void* path_cls, const void* path_node, const void* depth, int Lmax, int F,
               const void* sim, int C, const void* node_ceil, int N, float max_pen, float p_sub,
               float p_ins, float p_del, float p_swap, float floor_, int E, const void* graph,
               int nch, const void* node_caps, const void* root_caps) {
  if (E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 || limit < 0 || limit > npad ||
      nch < 1 || nch > MAX_NCH || graph == nullptr || node_caps == nullptr ||
      root_caps == nullptr) {
    return false;
  }
  c.ids = ids;
  c.ids_u8 = ids_u8;
  c.limit = limit;
  c.path_cls = static_cast<const int32_t*>(path_cls);
  c.path_node = static_cast<const int32_t*>(path_node);
  c.depth = static_cast<const int32_t*>(depth);
  c.Lmax = Lmax;
  c.sim = static_cast<const float*>(sim);
  c.C = C;
  c.node_ceil = static_cast<const float*>(node_ceil);
  c.max_pen = max_pen;
  c.p_sub = p_sub;
  c.p_ins = p_ins;
  c.p_del = p_del;
  c.p_swap = p_swap;
  c.floor_ = floor_;
  c.E = E;
  c.graph = static_cast<const int32_t*>(graph);
  c.nch = nch;
  c.node_caps = static_cast<const int32_t*>(node_caps);
  c.root_caps = static_cast<const int32_t*>(root_caps);
  return true;
}

template <int G>
cudaError_t launch_list_regs(const TypedListArgs& a, cudaStream_t stream) {
  const size_t shm = list_smem_bytes(G, a.core.E, a.core.nch, a.core.Lmax);
  cudaError_t rc = allow_smem(typed_dp_kernel<G>, shm);
  if (rc != cudaSuccess) return rc;
  const long long blocks = (a.items + TD_THREADS / G - 1) / (TD_THREADS / G);
  if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  typed_dp_kernel<G><<<(unsigned)blocks, TD_THREADS, shm, stream>>>(a);
  return cudaGetLastError();
}

// The blocks of typed_dp_rows_kernel<E, S, G> the card holds at once with
// ``shm`` bytes of shared memory a block: SMs x the occupancy query's
// answer, asked once per (instance, bytes).
template <int E, int S, int G>
cudaError_t resident_blocks(size_t shm, long long* blocks) {
  static std::mutex mu;
  static std::vector<std::pair<size_t, long long>> seen;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : seen) {
    if (e.first == shm) {
      *blocks = e.second;
      return cudaSuccess;
    }
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, typed_dp_rows_kernel<E, S, G>,
                                                       TR_THREADS, shm);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm;
  seen.emplace_back(shm, *blocks);
  return cudaSuccess;
}

// Launches typed_dp_rows_kernel<E, S, G> over the list: a grid of TR_WAVES
// times the card's resident blocks (a group's candidates then differ in
// depth and life less from its neighbours', and the blocks of later waves
// fill the SMs that finish first: 9 % less device time than one wave at
// typed14, NVIDIA H100), or of one block per TR_THREADS / G items where
// the list's bound is smaller.
template <int E, int S, int G>
cudaError_t launch_rows(const TypedListArgs& a, cudaStream_t stream) {
  const size_t shm = sizeof(int32_t) * (size_t)(TR_THREADS / G) *
                     rows_group_words(E, a.core.nch, a.core.Lmax);
  cudaError_t rc = allow_smem(typed_dp_rows_kernel<E, S, G>, shm);
  if (rc != cudaSuccess) return rc;
  long long cap = 0;
  rc = resident_blocks<E, S, G>(shm, &cap);
  if (rc != cudaSuccess) return rc;
  long long blocks = (a.items + TR_THREADS / G - 1) / (TR_THREADS / G);
  if (blocks > TR_WAVES * cap) blocks = TR_WAVES * cap;
  typed_dp_rows_kernel<E, S, G><<<(unsigned)blocks, TR_THREADS, shm, stream>>>(a);
  return cudaGetLastError();
}

// The instance of typed_dp_rows_kernel for E and nch > 32 / (2E + 1)
// channels: G = 16 lanes a candidate up to 16 channels, else 32 with
// ceil(nch / 32) slots a lane. E = 2 has at most 15 channels, E = 3 at most
// 35 (the vectors of four counts with sum <= E).
template <int E>
cudaError_t launch_rows_e(const TypedListArgs& a, cudaStream_t stream) {
  const int nch = a.core.nch;
  if (nch <= 16) return launch_rows<E, 1, 16>(a, stream);
  if constexpr (E >= 3) {
    if (nch <= 32) return launch_rows<E, 1, 32>(a, stream);
    if (nch <= 64) return launch_rows<E, 2, 32>(a, stream);
  }
  if constexpr (E >= 4) {
    if (nch <= 96) return launch_rows<E, 3, 32>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Candidates per row-count tile of the typed step, and (combo, hit) items
// per block of its expansion: the callers size row_counts (ntile =
// ceil(items / tile)) and the expansion's counts (nblk = ceil(items /
// expand_items)) from them.
int fac_typed_tile() { return TYPED_TILE; }
int fac_typed_expand_items() { return TE_TILE; }
// Waves of resident blocks in the grid of the typed DP past 32 cells (a
// list longer than that many groups makes its groups take turns).
int fac_typed_rows_waves() { return TR_WAVES; }

// The typed DP alone. cand_field, cand_start: int32 [M]; the DP tables as
// fac_banded_dp takes them; graph: int32 [nch, 10]; node_caps: int32 [N, 5];
// root_caps: int32 [5]; pen: f32 [(2E+1) nch, M]. Returns the launch's
// cudaError_t (0 = launched).
int fac_banded_dp_typed(const void* cand_field, const void* cand_start, long long M,
                        const void* ids, int ids_u8, long long npad, long long limit,
                        const void* path_cls, const void* path_node, const void* depth,
                        int Lmax, int F, const void* sim, int C, const void* node_ceil, int N,
                        float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
                        float floor_, int E, const void* graph, int nch,
                        const void* node_caps, const void* root_caps, void* pen,
                        void* stream) {
  TypedDpArgs a;
  if (M < 1 || !fill_core(a.core, ids, ids_u8, npad, limit, path_cls, path_node, depth, Lmax, F,
                          sim, C, node_ceil, N, max_pen, p_sub, p_ins, p_del, p_swap, floor_, E,
                          graph, nch, node_caps, root_caps)) {
    return (int)cudaErrorInvalidValue;
  }
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.M = M;
  a.pen_out = static_cast<float*>(pen);
  const size_t shm = smem_bytes(E, nch, Lmax);
  cudaError_t rc = allow_smem(banded_dp_typed_kernel, shm);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (M + TY_WARPS - 1) / TY_WARPS;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  banded_dp_typed_kernel<<<(unsigned)blocks, TY_THREADS, shm, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The typed step's expansion, one launch. pos: int64 [K]; words: int64 [K,
// W2]; the hits h0..K-1 are expanded; combos: int32 [5, n_combo]; nblk =
// ceil((K - h0) n_combo / fac_typed_expand_items()); status, epoch, base:
// lookback.cuh's array for nblk tiles (as fac_block_offsets takes them);
// the candidates go to cand_field, cand_start, cand_combo int32 [items] in
// item order, their total to total int32 [1]. Returns the launch's
// cudaError_t.
int fac_typed_expand(const void* pos, const void* words, long long K, long long h0, int W2,
                     const void* combos, int n_combo, long long start_lo, long long start_hi,
                     long long pos_hi, long long nblk, void* status, long long epoch,
                     long long base, void* cand_field, void* cand_start, void* cand_combo,
                     void* total, void* stream) {
  if (K < 1 || h0 < 0 || h0 >= K || W2 < 2 || n_combo < 1 || (K - h0) * n_combo > 0x7FFFFFFFll ||
      nblk != ((K - h0) * n_combo + TE_TILE - 1) / TE_TILE ||
      epoch < 1 || epoch > 0xFFFFFFFFll || base < 0 ||
      status == nullptr || cand_field == nullptr || cand_start == nullptr ||
      cand_combo == nullptr || total == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  TypedExpandArgs a;
  a.pos = static_cast<const long long*>(pos);
  a.words = static_cast<const long long*>(words);
  a.K = K;
  a.h0 = h0;
  a.W2 = W2;
  a.combos = static_cast<const int32_t*>(combos);
  a.n_combo = n_combo;
  a.start_lo = start_lo;
  a.start_hi = start_hi;
  a.pos_hi = pos_hi;
  a.nblk = nblk;
  a.status = static_cast<unsigned long long*>(status);
  a.epoch = (unsigned)epoch;
  a.base = (unsigned long long)base;
  a.cand_field = static_cast<int32_t*>(cand_field);
  a.cand_start = static_cast<int32_t*>(cand_start);
  a.cand_combo = static_cast<int32_t*>(cand_combo);
  a.total = static_cast<int32_t*>(total);
  typed_expand_kernel<<<(unsigned)nblk, TE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The typed DP over a candidate list and its decisions. cand_field,
// cand_start: int32 [items], the first *n_cand (on the card) live; the DP
// tables as fac_banded_dp_typed takes them; node: int32 [F]; out_list:
// int32 [N, MO]; pat_len, pat_weight: f32 [P]; limcls: int32 [P]; adm:
// int32 [nlc, nch]; dec: int32 [(2E+1) MO, items, 2] (columns past n_cand
// untouched); row_counts: int32 [nce * ntile + nce + 2], nce = (2E+1) MO,
// ntile = ceil(items / fac_typed_tile()): zeroed, then the rows per
// (channel, tile), per channel after them and in all are added, and n_cand
// written last (fac_count_dp's layout, which fac_count_emit reads). Returns
// the launch's cudaError_t.
int fac_typed_dp(const void* cand_field, const void* cand_start, const void* n_cand,
                 long long items, const void* ids, int ids_u8, long long npad, long long limit,
                 const void* path_cls, const void* path_node, const void* depth,
                 const void* node, int Lmax, int F, const void* sim, int C,
                 const void* node_ceil, int N, const void* out_list, int MO,
                 const void* pat_len, const void* pat_weight, float max_pen, float p_sub,
                 float p_ins, float p_del, float p_swap, float floor_, float bound, int E,
                 const void* graph, int nch, const void* node_caps, const void* root_caps,
                 const void* limcls, const void* adm, int nlc, void* dec, void* row_counts,
                 long long ntile, void* stream) {
  TypedListArgs a;
  if (items < 1 || MO < 1 || nlc < 1 || limcls == nullptr || adm == nullptr ||
      n_cand == nullptr || dec == nullptr || row_counts == nullptr ||
      !fill_core(a.core, ids, ids_u8, npad, limit, path_cls, path_node, depth, Lmax, F, sim, C,
                 node_ceil, N, max_pen, p_sub, p_ins, p_del, p_swap, floor_, E, graph, nch,
                 node_caps, root_caps) ||
      (2 * E + 1) * MO > MAX_CHANNELS || ntile != (items + TYPED_TILE - 1) / TYPED_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.n_cand = static_cast<const int32_t*>(n_cand);
  a.items = items;
  a.node = static_cast<const int32_t*>(node);
  a.out_list = static_cast<const int32_t*>(out_list);
  a.MO = MO;
  a.pat_len = static_cast<const float*>(pat_len);
  a.pat_weight = static_cast<const float*>(pat_weight);
  a.bound = bound;
  a.limcls = static_cast<const int32_t*>(limcls);
  a.adm = static_cast<const int32_t*>(adm);
  a.dec = static_cast<int2*>(dec);
  a.row_counts = static_cast<int32_t*>(row_counts);
  a.ntile = ntile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(row_counts, 0,
                                   sizeof(int32_t) * ((2 * E + 1) * MO * (ntile + 1) + 2), s);
  if (rc != cudaSuccess) return (int)rc;
  const int cells = (2 * E + 1) * nch;
  if (cells <= 8) return (int)launch_list_regs<8>(a, s);
  if (cells <= 16) return (int)launch_list_regs<16>(a, s);
  if (cells <= 32) return (int)launch_list_regs<32>(a, s);
  switch (E) {
    case 2: return (int)launch_rows_e<2>(a, s);
    case 3: return (int)launch_rows_e<3>(a, s);
    case 4: return (int)launch_rows_e<4>(a, s);
    case 5: return (int)launch_rows_e<5>(a, s);
    case 6: return (int)launch_rows_e<6>(a, s);
    default: return (int)cudaErrorInvalidValue;  // E = 1 has at most 15 cells
  }
}

}  // extern "C"
