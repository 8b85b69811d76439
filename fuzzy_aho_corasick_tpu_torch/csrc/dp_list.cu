// Count-channel banded Damerau DP over a candidate list, and its emission,
// for Hopper (sm_90a): the step of one corpus slice for every count-channel
// engine with E >= 2, forbidden edit types or mapping arrivals.
//
// Replaces, behind the expansion, the device body of the JAX package's
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_dp_pipeline_jit for those
// engines: _banded_dp (with its FORBID and MAPS options, verify_dp.py:355,
// :611) and _emit_rows, which XLA fused from whole-array ops. Plain torch
// versions (ops/verify_dp.py): count_dp_torch (banded_dp_torch, the band
// minimum and the emission test: count_decisions_torch) and
// count_emit_torch; wrappers verify_dp.count_dp and count_emit. The
// expansion in front is the typed step's typed_expand_kernel (dp_typed.cu,
// one launch): the candidate list (field, start, combo) in (combo, hit)
// item order, its total on the card.
//
// What it computes. Per candidate the recurrences of banded_dp.cuh's
// dp_body, cell for cell and in its f32 order: per row, the exact,
// substitution and swap arrivals into the consuming channel, the deletion
// into the continuation channel, then the mapping arrivals in the table's
// order (MAPS; the guard (q + mp) > max_pen), the emission channel (the
// consuming arrival or the trailing deletion from the previous row's
// emission channel), the insertions ascending b over the updated band b-1,
// the ceilings and the latch at i == depth. The forbid mask and the
// dead-end filter (an edit into the last level survives only where the
// row's node has output or a single-byte edge matching the next symbol)
// are run-time switches. Emission: per band the strict-< minimum over the
// NE edit channels, then per output slot the span test and the f32
// similarity test of banded_dp.cuh's emits(); the rows (start, penalty
// bits, span, pattern, packed counts) in (channel, candidate) order, which
// is the (channel, item) order emit_rows gives, and on request the tags
// channel * n_combo + combo.
//
// What bounds it on the H100, and the design. dp_pipeline_kernel ran one
// thread per uncompacted (combo, hit) item, a count pass and a write pass:
// about 4 % of a warp's lanes held a live chain, each chain's B x NE cells
// (15 at E = 2) were a dependent sequence in one thread, and every DP ran
// twice. The step is bound by that per-candidate latency, not by bytes (a
// slice reads ~1 MB of hits and tables). So, as the typed step does:
//   1. typed_expand_kernel compacts the candidates once;
//   2. count_dp_kernel<G, MAPS> gives each listed candidate a group of
//      G = 8, 16 or 32 lanes, one cell (b, e) per lane in registers (6, 15
//      and 28 cells at E = 1, 2, 3): the arrivals from rows i-1 and i-2 are
//      shuffles from lanes gl - 1 and gl + NE - 1, a mapping arrival from
//      lane (b - drift) NE + e - 1 of row i-1, i-2 or i-3 (row i-3 is kept
//      only in the MAPS instances), and the insertions a serial chain of
//      B - 1 shuffles. Past 32 cells (E = 4..6: 45-91 cells, the mapped
//      lane at edits(4)-(6) scans with 8-24 error rows) the cells no longer
//      fit a warp. A warp per candidate with its rows in shared memory
//      ran at 0.03 of its bound: two strided passes of 32 lanes over
//      the cells, each with a / NE and a % NE, 2E warp-synchronised
//      insertion steps with E lanes active, the mapping table reloaded for
//      every cell, every row to the depth, and a block barrier per stride
//      that held each warp to its stride's deepest candidate. So
//      count_dp_rows_kernel<E, MAPS> gives each candidate a group of 16
//      lanes, band b in lane b: its E + 1 channels of rows i-1, i-2 (i-3
//      with mappings) and of the emission channel in registers (compile-
//      time indices, an instance per E and MAPS); the substitution and the
//      swap read the lane itself, the deletions are one shuffle down, a
//      mapping arrival one shuffle from lane b - drift per channel (the
//      row's entries loaded once by the group's lanes, one each, and
//      broadcast), the insertions E shuffle steps; the band minimum and the
//      dead-end flag stay in the lane. A group stops once no lane holds a
//      finite value a later row reads (most candidates at E = 4 and 0.8 die
//      long before the depth), and the groups of a grid the size of the
//      card's resident blocks stride over the list with no block barrier,
//      adding their rows to the tiles' counts by atomics. The path's
//      classes, ceilings (and, with the dead-end filter, nodes and output
//      flags) and the haystack window are staged in shared memory by the
//      group before the row loop; the similarity table too where it fits
//      beside them in 48 KiB. The DP runs once. Per emission channel (band,
//      output slot) the group keeps (penalty bits, packed counts), or
//      (0, -1) for no row, in dec [nce, items], and counts its rows per
//      (channel, tile of LIST_TILE candidates) and in all (one atomic a
//      warp). The grid is capped and its blocks stride over the list, whose
//      total only the card knows.
//   3. the host reads the rows' and the candidates' totals, the last two
//      words of the row counts (the step's one host wait);
//   4. count_emit_kernel. It was a block of 1,024 threads per tile that
//      walked the nce channels in turn, each a dependent load, a ballot and
//      a warp-0 scan between three barriers, behind a block_offsets launch
//      over the row counts: forbid2's slice had 21 blocks for 132 SMs, and
//      its rows were five scattered 4-byte stores each. Bytes bound none of
//      it (a slice moves under 1 MB): the serial rounds and the launches
//      did. Now a block per (channel, tile) pair, nce x tiles blocks in
//      (channel, tile) order: a pair without a row leaves after one read;
//      four candidates a thread, one block scan ranks the rows, which are
//      staged in shared memory and stored as one stretch (int4 stores where
//      it aligns). No launch scans the counts: the DP also adds its rows per
//      channel, so a pair's first row is the totals of the channels before
//      it and the counts of the tiles before it in its channel, which the
//      block adds up beside its loads (a look-back over the pairs, and a
//      block_offsets launch's scan, both measured slower on the H100).

#include <mutex>
#include <vector>

#include "banded_dp.cuh"

namespace {

using namespace fac_dp;

constexpr int CL_THREADS = 256;   // the DP with register cells
constexpr int CR_THREADS = 128;   // the DP for E >= 4: groups of CR_G lanes, a band each
constexpr int CR_G = 16;          // lanes per candidate, B = 2E + 1 <= 13 of them live
constexpr int LIST_TILE = 1024;   // candidates per row-count tile (an emission block's)
constexpr int MAX_CHANNELS = 128;  // B * MO emission channels a call may have
constexpr int BLOCKS_PER_SM = 8;  // the capped grid of the DP
constexpr int EMIT_THREADS = 256;  // threads of an emission block: one (channel, tile) pair
constexpr int EMIT_PER = LIST_TILE / EMIT_THREADS;  // candidates per emission thread
static_assert(LIST_TILE % (CL_THREADS / 8) == 0,
              "a block's candidates of one stride lie in one tile");
static_assert(2 * MAX_E + 1 <= CR_G, "a band per lane of the rows DP's group");

struct ListArgs {
  DpCore core;
  int ids_u8;
  int E;
  int deadend;
  const int32_t* cand_field;  // [items] the candidate list, n_cand of them
  const int32_t* cand_start;
  const int32_t* n_cand;      // on the card: the expansion's offsets[nblk]
  long long items;            // the list's bound, dec's row stride
  EmitTables emit;
  int2* dec;                  // [nce, items]: (penalty bits, packed counts), counts -1 = no row
  int32_t* row_counts;        // [nce * ntile + 1]: rows per (channel, tile); n_cand last
  long long ntile;
  int sim_smem;               // the similarity table is staged in shared memory
  int lead_words;             // 4-byte words of shared memory before the groups'
  int group_words;            // 4-byte words of shared memory per group
};

__device__ __forceinline__ int hay(const ListArgs& a, long long p) {
  return a.ids_u8 ? hay_at(static_cast<const uint8_t*>(a.core.ids), p, a.core.limit)
                  : hay_at(static_cast<const int32_t*>(a.core.ids), p, a.core.limit);
}

// A group's staged copy of what its candidate's rows read: the path's
// classes and ceilings, with the dead-end filter its nodes and output flags,
// and the haystack window, win[o] = hay(s + o - E - 1) for o = -2 ..
// d + 2E + 1 (two symbols on the left for mapping arrivals, one on the
// right for the dead-end filter's next symbol).
// The emission's per-slot values of the candidate's output node: pattern
// (-1 where the slot is empty), its length and weight.
struct Staged {
  const int32_t* cls;
  const float* ceil;
  const int32_t* node;
  const int32_t* hasout;
  const int32_t* win;
  const int32_t* pat;
  const float* pl;
  const float* pw;
};

__host__ __device__ inline int staged_words(int Lmax, int E, bool deadend, int MO) {
  return (deadend ? 4 : 2) * Lmax + Lmax + 2 * E + 4 + 3 * MO;
}

// The group's lanes (gl of G) stage candidate (f, depth d, start s). The
// path's rows are read up to Lmax, so that no load waits for the depth.
__device__ __forceinline__ Staged stage(const ListArgs& a, int32_t* mem, int f, int d, int s,
                                        int gl, int G) {
  const DpCore& c = a.core;
  const int L = c.Lmax, E = a.E, MO = a.emit.MO;
  Staged st;
  int32_t* cls = mem;
  float* ceil = reinterpret_cast<float*>(mem + L);
  int32_t* node = mem + 2 * L;
  int32_t* hasout = mem + 3 * L;
  int32_t* win = mem + (a.deadend ? 4 : 2) * L;
  int32_t* pat = win + L + 2 * E + 4;
  float* pl = reinterpret_cast<float*>(pat + MO);
  float* pw = pl + MO;
  const int32_t* pcls = c.path_cls + (long long)f * L;
  const int32_t* pnode = c.path_node + (long long)f * L;
  for (int r = gl; r < L; r += G) {
    cls[r] = __ldg(pcls + r);
    const int pn = max(__ldg(pnode + r), 0);  // rows past the depth are never read
    ceil[r] = __ldg(c.node_ceil + pn);
    if (a.deadend) {
      node[r] = pn;
      hasout[r] = __ldg(c.out_count + pn) > 0;
    }
  }
  for (int t = gl; t < d + 2 * E + 4; t += G) win[t] = hay(a, (long long)s + t - 2 - E - 1);
  const int out = __ldg(a.emit.node + f);
  for (int o = gl; o < MO; o += G) {
    const int p = __ldg(a.emit.out_list + (long long)out * MO + o);
    pat[o] = p;
    pl[o] = p >= 0 ? __ldg(a.emit.pat_len + p) : 0.f;
    pw[o] = p >= 0 ? __ldg(a.emit.pat_weight + p) : 0.f;
  }
  st.cls = cls;
  st.ceil = ceil;
  st.node = node;
  st.hasout = hasout;
  st.win = win + 2;
  st.pat = pat;
  st.pl = pl;
  st.pw = pw;
  return st;
}

__device__ __forceinline__ float sim_of(const DpCore& c, const float* s_sim, bool staged, int k) {
  return staged ? s_sim[k] : __ldg(c.sim + k);
}

// Whether an edit into the last level of band b survives the dead-end
// filter at row i.
__device__ __forceinline__ bool ok_row(const DpCore& c, const Staged& st, int i, int b) {
  const int nxt = st.win[i + b + 1];
  return st.hasout[i - 1] != 0 ||
         (nxt >= 0 && __ldg(c.sb_edge + (long long)st.node[i - 1] * c.C + nxt) > 0);
}

// The DP of one candidate (field f, depth d) with one cell per lane: lane
// gl < B * NE of a group of G lanes (mask gm) holds cell (b, e) = (gl / NE,
// gl % NE). Returns the lane's cell of the emission channel at row d
// (+inf where dead).
template <int G, bool MAPS>
__device__ __forceinline__ void count_dp_lanes(const ListArgs& a, const float* s_sim,
                                               const Staged& st, int f, int d, int gl,
                                               unsigned gm, float& out_pen, int& out_cnt) {
  const DpCore& c = a.core;
  const int E = a.E, B = 2 * E + 1, NE = E + 1;
  const float INF = __int_as_float(0x7f800000);
  const float max_pen = c.max_pen;
  const bool sim_smem = a.sim_smem != 0;
  const bool no_ins = c.forbid & 1, no_del = c.forbid & 2, no_sub = c.forbid & 4,
             no_swap = c.forbid & 8;
  const bool mine = gl < B * NE;
  const int b = mine ? gl / NE : 0, e = mine ? gl - (gl / NE) * NE : 0;
  // Each arrival's source lane (the lane itself where there is none).
  const bool has_sub = mine && e >= 1;               // (b, e-1): substitution, swap
  const bool has_del = has_sub && b + 1 < B;         // (b+1, e-1): deletions
  const bool has_ins = has_sub && b >= 1;            // (b-1, e-1): insertion
  const int l_sub = has_sub ? gl - 1 : gl;
  const int l_del = has_del ? gl + NE - 1 : gl;
  const int l_ins = has_ins ? gl - NE - 1 : gl;
  const bool last = a.deadend && mine && e == NE - 1;

  // Row 0 is the origin (band E, no edits); rows below 0 are dead.
  float prev_pen = (mine && b == E && e == 0) ? 0.f : INF, prev2_pen = INF, prev3_pen = INF;
  int prev_cnt = 0, prev2_cnt = 0, prev3_cnt = 0;
  float preve_pen = prev_pen;
  int preve_cnt = 0;
  // Row i-1's path class and this band's symbol there: row i's pc_prev and
  // hc_jm1 (row 1 reads path class 0, as dp_body does).
  int pc_prev = st.cls[0], hc_jm1 = st.win[b];
#pragma unroll 1
  for (int i = 1; i <= d; ++i) {
    const int pc = st.cls[i - 1];
    const float ceil_i = st.ceil[i - 1];
    const int j = i + b - E;  // haystack symbols consumed at this cell
    const int hc = st.win[i + b];
    const bool okrow = !last || ok_row(c, st, i, b);
    float sim = 0.f;
    if (hc >= 0) sim = sim_of(c, s_sim, sim_smem, pc * c.C + hc);
    const float spen = __fmul_rn(c.p_sub, __fsub_rn(1.f, sim));
    const float q = __shfl_sync(gm, prev_pen, l_sub, G);
    const int qc = __shfl_sync(gm, prev_cnt, l_sub, G);
    const float sw = __shfl_sync(gm, prev2_pen, l_sub, G);
    const int swc = __shfl_sync(gm, prev2_cnt, l_sub, G);
    const float dl = __shfl_sync(gm, prev_pen, l_del, G);
    const int dlc = __shfl_sync(gm, prev_cnt, l_del, G);
    const float te = __shfl_sync(gm, preve_pen, l_del, G);
    const int tec = __shfl_sync(gm, preve_cnt, l_del, G);

    // exact: (i-1, b, e), no edit; the count rides along even where dead.
    // A penalty is finite or +inf, never -inf or NaN: dp_body's fin() tests
    // are left out where the result is the same without them (an +inf
    // source fails the budget guard or loses the strict-< merge).
    float bp = (j >= 1 && hc == pc) ? prev_pen : INF;
    int bc = prev_cnt;
    if (has_sub) {
      // substitution: (i-1, b, e-1)
      const bool ok_s = !no_sub && j >= 1 && hc >= 0 && hc != pc && !(sim < c.floor_) &&
                        !(spen > __fsub_rn(max_pen, q)) && okrow;
      merge(bp, bc, __fadd_rn(q, spen), qc + 0x10000, ok_s);
      // swap: (i-2, b, e-1); the symbol test first, which few cells pass.
      if (hc == pc_prev && hc_jm1 == pc) {
        const bool ok_sw = !no_swap && i >= 2 && j >= 2 && hc >= 0 && hc_jm1 >= 0 &&
                           !(c.p_swap > __fsub_rn(max_pen, sw));
        merge(bp, bc, __fadd_rn(sw, c.p_swap), swc + 0x1000000, ok_sw);
      }
    }
    float cons_pen = bp;
    int cons_cnt = bc;
    if (has_del) {
      // deletion: (i-1, b+1, e-1), consumes pc only
      const bool ok_d = !no_del && !(c.p_del > __fsub_rn(max_pen, dl)) && okrow;
      merge(bp, bc, __fadd_rn(dl, c.p_del), dlc + 0x100, ok_d);
    }

    // Mapping arrivals targeting row i, in the table's order: from (row
    // i-pb, band b-drift, e-1), consuming ha symbols equal to the entry's
    // classes, into the consuming and the continuation channel.
    if constexpr (MAPS) {
      const int m1 = __ldg(c.map_rowptr + i + 1);
#pragma unroll 1
      for (int mi = __ldg(c.map_rowptr + i); mi < m1; ++mi) {
        const int32_t* me = c.map_tab + (long long)mi * MAP_COLS;
        const int pb = __ldg(me + 1);
        if (i - pb < 0) continue;
        const int fw = __ldg(c.map_fields + (long long)mi * c.map_fw + (f >> 5));
        if (!((fw >> (f & 31)) & 1)) continue;
        const int drift = __ldg(me + 2), ha = __ldg(me + 3);
        const float mp = __int_as_float(__ldg(me + 8));
        const int bs = b - drift;
        bool ok_m = has_sub && bs >= 0 && bs < B && j >= ha;
#pragma unroll
        for (int u = 0; u < MAP_HA_MAX; ++u)
          ok_m = ok_m && (u >= ha || st.win[i + b - u] == __ldg(me + 4 + u));
        const int l_m = ok_m ? bs * NE + e - 1 : gl;
        const float src_p = pb == 1 ? prev_pen : pb == 2 ? prev2_pen : prev3_pen;
        const int src_c = pb == 1 ? prev_cnt : pb == 2 ? prev2_cnt : prev3_cnt;
        const float qm = __shfl_sync(gm, src_p, l_m, G);
        const int qmc = __shfl_sync(gm, src_c, l_m, G);
        if (ok_m) {
          const float val = __fadd_rn(qm, mp);
          const bool ok_e = !(val > max_pen);
          merge(cons_pen, cons_cnt, val, qmc + 0x10000, ok_e);
          merge(bp, bc, val, qmc + 0x10000, ok_e);
        }
      }
    }

    // The emission channel: the consuming arrival, or the trailing deletion
    // from the emission channel of row i-1 at band b+1.
    float ep = cons_pen;
    int ec = cons_cnt;
    if (has_del) {
      const bool ok_t = !no_del && !(c.p_del > __fsub_rn(max_pen, te)) && okrow;
      merge(ep, ec, __fadd_rn(te, c.p_del), tec + 0x100, ok_t);
    }

    // insertion: same row, (b-1, e-1) -> b, ascending b over the updated
    // band b-1; none from cells with zero hay consumed (j - 1 >= 1). A
    // cell's source sits one edit level lower and is final once that level
    // has merged its own, so the levels e = 1 .. E take turns: the value
    // each cell reads is the one dp_body's ascending-b loop reads.
    for (int t = 1; t < NE; ++t) {
      const float ip = __shfl_sync(gm, bp, l_ins, G);
      const int ic = __shfl_sync(gm, bc, l_ins, G);
      if (has_ins && e == t) {
        const bool ok_i = !no_ins && j >= 2 && hc >= 0 && !(c.p_ins > __fsub_rn(max_pen, ip)) &&
                          okrow;
        merge(bp, bc, __fadd_rn(ip, c.p_ins), ic + 1, ok_i);
      }
    }

    // Ceilings, then the rows move up.
    if (bp > ceil_i) bp = INF;
    if constexpr (MAPS) {
      prev3_pen = prev2_pen;
      prev3_cnt = prev2_cnt;
    }
    prev2_pen = prev_pen;
    prev2_cnt = prev_cnt;
    prev_pen = bp;
    prev_cnt = bc;
    preve_pen = ep > ceil_i ? INF : ep;
    preve_cnt = ec;
    pc_prev = pc;
    hc_jm1 = hc;
    // Where every cell of the rows later rows read is dead, so is every
    // later cell and the emission at row d: the group stops.
    if (!__any_sync(gm, fin(prev_pen) || fin(prev2_pen) || fin(preve_pen) ||
                            (MAPS && fin(prev3_pen))))
      break;
  }
  out_pen = d >= 1 ? preve_pen : INF;
  out_cnt = d >= 1 ? preve_cnt : 0;
}

// The same DP for E >= 4 with one band per lane: lane b < B = 2E + 1 of a
// group of CR_G = 16 lanes (mask gm) holds the NE = E + 1 channels of band b
// of rows i-1, i-2 (and i-3 with mappings) and of row i-1's emission
// channel in registers. The substitution and the swap read the lane's own
// registers; the deletions (band b+1) are a shuffle down by one lane; a
// mapping arrival (band b - drift) one shuffle from that lane per channel;
// the insertions E shuffle steps up by one lane, step t settling channel t
// of every band from channel t-1 of the band below, which step t-1
// settled: the value dp_body's ascending-b loop reads. ``rowptr`` is
// map_rowptr staged in shared memory (MAPS). Returns the lane's band of the
// emission channel at row d (+inf where dead); the group stops once no
// lane holds a finite value that a later row reads.
template <int E, bool MAPS>
__device__ __forceinline__ void count_dp_bands(const ListArgs& a, const float* s_sim,
                                               const int32_t* rowptr, const Staged& st, int f,
                                               int d, int b, unsigned gm, float (&out_pen)[E + 1],
                                               int (&out_cnt)[E + 1]) {
  constexpr int B = 2 * E + 1, NE = E + 1;
  const DpCore& c = a.core;
  const float INF = __int_as_float(0x7f800000);
  const float max_pen = c.max_pen;
  const bool sim_smem = a.sim_smem != 0;
  const bool no_ins = c.forbid & 1, no_del = c.forbid & 2, no_sub = c.forbid & 4,
             no_swap = c.forbid & 8;
  const bool mine = b < B;
  const bool has_del = mine && b + 1 < B;  // (b+1, e-1): deletions
  const bool has_ins = mine && b >= 1;     // (b-1, e-1): insertion
  const int bw = mine ? b : 0;             // the band whose window an idle lane reads
  const int gbase = threadIdx.x & 31 & ~(CR_G - 1);

  float p1[NE], p2[NE], pe[NE], p3[MAPS ? NE : 1];
  int c1[NE], c2[NE], ce[NE], c3[MAPS ? NE : 1];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    p1[e] = p2[e] = pe[e] = INF;
    c1[e] = c2[e] = ce[e] = 0;
    if constexpr (MAPS) {
      p3[e] = INF;
      c3[e] = 0;
    }
  }
  // Row 0 is the origin (band E, no edits); rows below 0 are dead.
  if (b == E) p1[0] = pe[0] = 0.f;
  // Whether the lane's row i-1 (and i-2) held a finite cell: with rows i
  // and its emission channel, what later rows read. Penalties are finite
  // or +inf, so a row's minimum tells.
  bool held1 = b == E, held2 = false;
  // The band's symbols of rows i-1, i-2 and i-3 (row i reads win[i + b - u],
  // u = 0..3: the swap u = 1, a mapping arrival up to 3); row i-1's class.
  int h1 = st.win[bw], h2 = st.win[bw - 1], h3 = st.win[bw - 2];
  int pc_prev = st.cls[0];
#pragma unroll 1
  for (int i = 1; i <= d; ++i) {
    const int pc = st.cls[i - 1];
    const float ceil_i = st.ceil[i - 1];
    const int j = i + b - E;  // haystack symbols consumed at this cell
    const int hc = st.win[i + bw];
    const bool okrow = !a.deadend || ok_row(c, st, i, bw);
    float sim = 0.f;
    if (hc >= 0) sim = sim_of(c, s_sim, sim_smem, pc * c.C + hc);
    const float spen = __fmul_rn(c.p_sub, __fsub_rn(1.f, sim));
    // Band b+1's channels of row i-1 and of its emission channel.
    float dl[E], te[E];
    int dlc[E], tec[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dl[e] = __shfl_down_sync(gm, p1[e], 1, CR_G);
      dlc[e] = __shfl_down_sync(gm, c1[e], 1, CR_G);
      te[e] = __shfl_down_sync(gm, pe[e], 1, CR_G);
      tec[e] = __shfl_down_sync(gm, ce[e], 1, CR_G);
    }
    const bool sw_sym = i >= 2 && j >= 2 && hc >= 0 && h1 >= 0 && hc == pc_prev && h1 == pc;

    // Per channel: exact, substitution and swap into the consuming
    // channel, then the deletion into the continuation channel.
    float np[NE], cp[NE];
    int nc[NE], cc[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const bool ok_last = e < NE - 1 || okrow;  // the dead-end filter: last level only
      const float p = p1[e];
      float bp = (j >= 1 && fin(p) && hc == pc) ? p : INF;
      int bc = c1[e];
      if (e >= 1) {
        const float q = p1[e - 1];
        const bool ok_s = mine && !no_sub && j >= 1 && fin(q) && hc >= 0 && hc != pc &&
                          !(sim < c.floor_) && !(spen > __fsub_rn(max_pen, q)) && ok_last;
        merge(bp, bc, __fadd_rn(q, spen), c1[e - 1] + 0x10000, ok_s);
        const float sw = p2[e - 1];
        const bool ok_sw = mine && !no_swap && sw_sym && fin(sw) &&
                           !(c.p_swap > __fsub_rn(max_pen, sw));
        merge(bp, bc, __fadd_rn(sw, c.p_swap), c2[e - 1] + 0x1000000, ok_sw);
      }
      cp[e] = bp;
      cc[e] = bc;
      if (e >= 1) {
        const float x = dl[e - 1];
        const bool ok_d = has_del && !no_del && fin(x) && !(c.p_del > __fsub_rn(max_pen, x)) &&
                          ok_last;
        merge(bp, bc, __fadd_rn(x, c.p_del), dlc[e - 1] + 0x100, ok_d);
      }
      np[e] = bp;
      nc[e] = bc;
    }

    // Mapping arrivals targeting row i, in the table's order: from (row
    // i-pb, band b-drift, e-1), consuming ha symbols equal to the entry's
    // classes, into the consuming and the continuation channel; the
    // oracle's guard (q + mp) > max_pen. The group's lanes load the row's
    // entries, one each, and broadcast those that apply to field f.
    if constexpr (MAPS) {
      const int m1 = rowptr[i + 1];
#pragma unroll 1
      for (int m0 = rowptr[i]; m0 < m1; m0 += CR_G) {
        const int mi = m0 + b;
        int meta = 0, k0 = -2, k1 = -2, k2 = -2, k3 = -2;
        float mp = 0.f;
        bool applies = false;
        if (mi < m1) {
          const int32_t* me = c.map_tab + (long long)mi * MAP_COLS;
          const int pb = __ldg(me + 1);
          const int fw = __ldg(c.map_fields + (long long)mi * c.map_fw + (f >> 5));
          applies = i - pb >= 0 && ((fw >> (f & 31)) & 1);
          meta = pb | ((__ldg(me + 2) + 64) << 2) | (__ldg(me + 3) << 9);
          k0 = __ldg(me + 4);
          k1 = __ldg(me + 5);
          k2 = __ldg(me + 6);
          k3 = __ldg(me + 7);
          mp = __int_as_float(__ldg(me + 8));
        }
        unsigned todo = (__ballot_sync(gm, applies) >> gbase) & 0xFFFFu;
        while (todo != 0) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int em = __shfl_sync(gm, meta, src, CR_G);
          const int u0 = __shfl_sync(gm, k0, src, CR_G), u1 = __shfl_sync(gm, k1, src, CR_G),
                    u2 = __shfl_sync(gm, k2, src, CR_G), u3 = __shfl_sync(gm, k3, src, CR_G);
          const float emp = __shfl_sync(gm, mp, src, CR_G);
          const int pb = em & 3, drift = ((em >> 2) & 127) - 64, ha = em >> 9;
          const int bs = b - drift;
          const bool ok_m = mine && bs >= 0 && bs < B && j >= ha && (ha < 1 || hc == u0) &&
                            (ha < 2 || h1 == u1) && (ha < 3 || h2 == u2) && (ha < 4 || h3 == u3);
#pragma unroll
          for (int e = 1; e < NE; ++e) {
            const float sp = pb == 1 ? p1[e - 1] : pb == 2 ? p2[e - 1] : p3[e - 1];
            const int sc = pb == 1 ? c1[e - 1] : pb == 2 ? c2[e - 1] : c3[e - 1];
            const float q = __shfl_sync(gm, sp, bs & (CR_G - 1), CR_G);
            const int qc = __shfl_sync(gm, sc, bs & (CR_G - 1), CR_G) + 0x10000;
            const float val = __fadd_rn(q, emp);
            const bool ok_e = ok_m && fin(q) && !(val > max_pen);
            merge(cp[e], cc[e], val, qc, ok_e);
            merge(np[e], nc[e], val, qc, ok_e);
          }
        }
      }
    }

    // The emission channel: the consuming arrival, or the trailing deletion
    // from the emission channel of row i-1 at band b+1; its ceiling.
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      float ep = cp[e];
      int ec = cc[e];
      if (e >= 1) {
        const float x = te[e - 1];
        const bool ok_t = has_del && !no_del && fin(x) && !(c.p_del > __fsub_rn(max_pen, x)) &&
                          (e < NE - 1 || okrow);
        merge(ep, ec, __fadd_rn(x, c.p_del), tec[e - 1] + 0x100, ok_t);
      }
      pe[e] = ep > ceil_i ? INF : ep;
      ce[e] = ec;
    }

    // insertion: same row, (b-1, e-1) -> b over the updated band b-1; none
    // from cells with zero hay consumed (j - 1 >= 1).
    const bool ins_row = has_ins && !no_ins && j >= 2 && hc >= 0;
#pragma unroll
    for (int e = 1; e < NE; ++e) {
      const float ip = __shfl_up_sync(gm, np[e - 1], 1, CR_G);
      const int ic = __shfl_up_sync(gm, nc[e - 1], 1, CR_G);
      const bool ok_i = ins_row && fin(ip) && !(c.p_ins > __fsub_rn(max_pen, ip)) &&
                        (e < NE - 1 || okrow);
      merge(np[e], nc[e], __fadd_rn(ip, c.p_ins), ic + 1, ok_i);
    }

    // Ceilings, then the rows move up.
    float lo = INF;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if constexpr (MAPS) {
        p3[e] = p2[e];
        c3[e] = c2[e];
      }
      p2[e] = p1[e];
      c2[e] = c1[e];
      p1[e] = np[e] > ceil_i ? INF : np[e];
      c1[e] = nc[e];
      lo = fminf(lo, p1[e]);
    }
    float lo_e = INF;
#pragma unroll
    for (int e = 0; e < NE; ++e) lo_e = fminf(lo_e, pe[e]);
    const bool held0 = lo < INF;
    const bool live = held0 || lo_e < INF || held1 || (MAPS && held2);
    held2 = held1;
    held1 = held0;
    pc_prev = pc;
    h3 = h2;
    h2 = h1;
    h1 = hc;
    // Where no cell that a later row reads is finite, no later cell is,
    // nor the emission at row d: the group stops.
    if (!__any_sync(gm, live)) break;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    out_pen[e] = d >= 1 ? pe[e] : INF;
    out_cnt[e] = ce[e];
  }
}

// Per emission channel (b, slot o) of candidate m, lane b of its group
// decides the row from its band of the emission channel at row d (strict
// <, edit counts ascending: the fewest edits win penalty ties), writes dec
// and adds the row to its (channel, tile) count: emits() of banded_dp.cuh
// on the staged slot values. Returns the band's rows.
template <int E>
__device__ __forceinline__ int band_decide(const ListArgs& a, const Staged& st,
                                           const float (&pen)[E + 1], const int (&cnt)[E + 1],
                                           int d, int start, long long m, int b) {
  const int MO = a.emit.MO;
  float pb = pen[0];
  int cb = cnt[0];
#pragma unroll
  for (int e = 1; e < E + 1; ++e) {
    if (pen[e] < pb) {
      pb = pen[e];
      cb = cnt[e];
    }
  }
  const int ends_b = start + d + (b - E);
  const bool span = fin(pb) && ends_b <= a.core.limit && ends_b >= start;
  int rows = 0;
  for (int o = 0; o < MO; ++o) {
    const int ce = b * MO + o;
    bool row = span && st.pat[o] >= 0;
    if (row) {
      const float pl = st.pl[o];
      row = __fmul_rn(__fdiv_rn(__fsub_rn(pl, pb), pl), st.pw[o]) >= a.emit.bound;
    }
    int2 out = make_int2(0, -1);
    if (row) {
      out = make_int2(__float_as_int(pb), cb);
      atomicAdd(a.row_counts + (long long)ce * a.ntile + m / LIST_TILE, 1);
      atomicAdd(a.row_counts + (long long)(2 * E + 1) * MO * a.ntile + ce, 1);
      ++rows;
    }
    a.dec[(long long)ce * a.items + m] = out;
  }
  return rows;
}

// Per emission channel ce = (band, slot) of candidate m, the lanes of its
// group (gl of G) decide the row from its emission channel at row d
// (pen / cnt [B * NE], shared memory) and count it in s_cnt: emits() of
// banded_dp.cuh on the staged slot values.
__device__ __forceinline__ void count_decide(const ListArgs& a, const Staged& st,
                                             const float* pen, const int* cnt, int d, int start,
                                             long long m, int gl, int G, int* s_cnt) {
  const int E = a.E, NE = E + 1, MO = a.emit.MO, nce = (2 * E + 1) * MO;
  for (int ce = gl; ce < nce; ce += G) {
    const int b = ce / MO, o = ce - b * MO;
    // Strict <, edit counts ascending: the fewest edits win penalty ties.
    float pb = d >= 1 ? pen[b * NE] : __int_as_float(0x7f800000);
    int cb = cnt[b * NE];
    for (int e = 1; e < NE; ++e) {
      if (pen[b * NE + e] < pb) {
        pb = pen[b * NE + e];
        cb = cnt[b * NE + e];
      }
    }
    const int ends_b = start + d + (b - E);
    bool row = fin(pb) && ends_b <= a.core.limit && ends_b >= start && st.pat[o] >= 0;
    if (row) {
      const float pl = st.pl[o];
      row = __fmul_rn(__fdiv_rn(__fsub_rn(pl, pb), pl), st.pw[o]) >= a.emit.bound;
    }
    int2 out = make_int2(0, -1);
    if (row) {
      out = make_int2(__float_as_int(pb), cb);
      atomicAdd(s_cnt + ce, 1);
    }
    a.dec[(long long)ce * a.items + m] = out;
  }
}

// Shared memory of a DP block, in 4-byte words: the block's row counts
// (count_dp_kernel) or the staged map_rowptr (count_dp_rows_kernel with
// mappings), the groups' staged rows and their cells, then the similarity
// table where it is staged.
__host__ __device__ inline int block_words(const ListArgs& a, int groups) {
  return a.lead_words + groups * a.group_words;
}

// Every thread of a block that holds a candidate stages the similarity
// table; the block-uniform test comes first.
__device__ __forceinline__ void load_sim_table(const ListArgs& a, float* s_sim) {
  if (a.sim_smem) {
    const int n = a.core.C * a.core.C;
    for (int t = threadIdx.x; t < n; t += blockDim.x) s_sim[t] = __ldg(a.core.sim + t);
  }
}

// The row counts' layout: rows per (channel, tile) channel-major from
// word 0, then rows per channel from word nce * ntile, the rows' total and
// the candidates' total.
__device__ __forceinline__ long long channel_totals(const ListArgs& a, int nce) {
  return (long long)nce * a.ntile;
}

// Adds ``rows`` of each lane of the warp to the rows' total: one atomic a
// warp.
__device__ __forceinline__ void add_rows(const ListArgs& a, int nce, int rows) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rows += __shfl_xor_sync(0xFFFFFFFFu, rows, o);
  if ((threadIdx.x & 31) == 0 && rows != 0)
    atomicAdd(a.row_counts + channel_totals(a, nce) + nce, rows);
}

// One stride of a block: candidates first .. first + groups - 1 run by
// ``run(m, group, lane of the group)``, then the stride's row counts are
// added to their tile's.
template <typename Run>
__device__ __forceinline__ void strides(const ListArgs& a, int* s_cnt, float* s_sim, int groups,
                                        Run run) {
  const int nce = (2 * a.E + 1) * a.emit.MO;
  const int n_cand = __ldg(a.n_cand);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.row_counts[channel_totals(a, nce) + nce + 1] = n_cand;
  long long first = (long long)blockIdx.x * groups;
  if (first >= n_cand) return;
  load_sim_table(a, s_sim);
  for (; first < n_cand; first += (long long)gridDim.x * groups) {
    for (int t = threadIdx.x; t < nce; t += blockDim.x) s_cnt[t] = 0;
    __syncthreads();
    run(first);
    __syncthreads();
    int rows = 0;
    for (int t = threadIdx.x; t < nce; t += blockDim.x) {
      if (s_cnt[t] != 0) {
        atomicAdd(a.row_counts + (long long)t * a.ntile + first / LIST_TILE, s_cnt[t]);
        atomicAdd(a.row_counts + channel_totals(a, nce) + t, s_cnt[t]);
        rows += s_cnt[t];
      }
    }
    add_rows(a, nce, rows);
    __syncthreads();  // s_cnt is zeroed again
  }
}

// The DP over the list with one cell per lane: a group of G lanes per
// candidate ((2E+1)(E+1) <= G).
template <int G, bool MAPS>
__global__ void __launch_bounds__(CL_THREADS) count_dp_kernel(ListArgs a) {
  extern __shared__ int32_t s_mem[];
  constexpr int GROUPS = CL_THREADS / G;
  int* s_cnt = s_mem;
  int32_t* s_groups = s_mem + a.lead_words;
  float* s_sim = reinterpret_cast<float*>(s_mem + block_words(a, GROUPS));
  const int grp = threadIdx.x / G, gl = threadIdx.x % G;
  const unsigned gm =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  int32_t* mem = s_groups + grp * a.group_words;
  strides(a, s_cnt, s_sim, GROUPS, [&](long long first) {
    const long long m = first + grp;
    if (m >= __ldg(a.n_cand)) return;
    const int f = __ldg(a.cand_field + m);
    const int start = __ldg(a.cand_start + m);
    const int d = __ldg(a.core.depth + f);
    const Staged st = stage(a, mem, f, d, start, gl, G);
    __syncwarp(gm);
    float pen;
    int cnt;
    count_dp_lanes<G, MAPS>(a, s_sim, st, f, d, gl, gm, pen, cnt);
    float* ebuf =
        reinterpret_cast<float*>(mem + staged_words(a.core.Lmax, a.E, a.deadend, a.emit.MO));
    int* cbuf = reinterpret_cast<int*>(ebuf + G);
    ebuf[gl] = pen;
    cbuf[gl] = cnt;
    __syncwarp(gm);
    count_decide(a, st, ebuf, cbuf, d, start, m, gl, G, s_cnt);
    __syncwarp(gm);  // the group's memory is staged again
  });
}

// The DP over the list for E >= 4: a group of CR_G = 16 lanes per
// candidate, a band per lane (count_dp_bands). The groups of the capped
// grid stride over the list on their own: a group whose candidate dies
// early takes its next one at once, with no block barrier after the
// staging; its rows go to their tiles' counts by atomics.
template <int E, bool MAPS>
__global__ void __launch_bounds__(CR_THREADS) count_dp_rows_kernel(ListArgs a) {
  extern __shared__ int32_t s_mem[];
  constexpr int GROUPS = CR_THREADS / CR_G;
  int32_t* rowptr = s_mem;
  int32_t* s_groups = s_mem + a.lead_words;
  float* s_sim = reinterpret_cast<float*>(s_mem + block_words(a, GROUPS));
  const int n_cand = __ldg(a.n_cand);
  constexpr int B = 2 * E + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    a.row_counts[channel_totals(a, B * a.emit.MO) + B * a.emit.MO + 1] = n_cand;
  if ((long long)blockIdx.x * GROUPS >= n_cand) return;
  load_sim_table(a, s_sim);
  if constexpr (MAPS)
    for (int t = threadIdx.x; t < a.core.Lmax + 2; t += CR_THREADS)
      rowptr[t] = __ldg(a.core.map_rowptr + t);
  __syncthreads();
  const int grp = threadIdx.x / CR_G, b = threadIdx.x % CR_G;
  const unsigned gm = 0xFFFFu << (threadIdx.x & 31 & ~(CR_G - 1));
  int32_t* mem = s_groups + grp * a.group_words;
  const long long stride = (long long)gridDim.x * GROUPS;
  int rows = 0;  // this lane's rows over its group's candidates
  for (long long m = (long long)blockIdx.x * GROUPS + grp; m < n_cand; m += stride) {
    const int f = __ldg(a.cand_field + m);
    const int start = __ldg(a.cand_start + m);
    const int d = __ldg(a.core.depth + f);
    const Staged st = stage(a, mem, f, d, start, b, CR_G);
    __syncwarp(gm);
    float pen[E + 1];
    int cnt[E + 1];
    count_dp_bands<E, MAPS>(a, s_sim, rowptr, st, f, d, b, gm, pen, cnt);
    if (b < 2 * E + 1) rows += band_decide<E>(a, st, pen, cnt, d, start, m, b);
    __syncwarp(gm);  // the group's memory is staged again
  }
  add_rows(a, (2 * E + 1) * a.emit.MO, rows);  // the warp's groups have all left the loop
}

struct EmitArgs {
  const int32_t* cand_field;  // the candidate list
  const int32_t* cand_start;
  const int32_t* cand_combo;
  const int32_t* n_cand;
  long long items;
  const int32_t* depth;       // [F]
  const int32_t* node;        // [F]
  const int32_t* out_list;    // [N, MO]
  int MO, E, n_combo;
  const int2* dec;            // [nce, items]
  // A row's packed counts: counts[y * counts_stride] of its decision's
  // column y (the typed step's graph column of channel y), or y itself
  // where counts is null (the count step's).
  const int32_t* counts;
  int counts_stride;
  const int32_t* row_counts;  // [nce * ntile + nce + 2], count_dp's (or typed_dp's)
  long long ntile;            // tiles of the list's bound (the row counts' stride)
  long long live_tiles;       // tiles of the candidates the host counted
  int32_t* rows;              // [total, 5]
  int32_t* tags;              // [total] or null
};

// Block p places the rows of the (channel, tile) pair p = channel *
// live_tiles + tile: EMIT_PER candidates a thread, one block scan of their
// row flags ranks the rows, which are staged in shared memory in rank
// order and stored as one stretch (16-byte stores where the stretch
// aligns), the tags beside them. The pair's first row is the rows of the
// channels before it (their totals) and of the tiles before it in its
// channel, added up by the block beside its loads and its ranking.
__global__ void __launch_bounds__(EMIT_THREADS) count_emit_kernel(EmitArgs a) {
  __shared__ int s_warp[EMIT_THREADS / 32];
  __shared__ int s_part[EMIT_THREADS / 32];
  __shared__ __align__(16) int32_t s_rows[LIST_TILE * 5];
  __shared__ int32_t s_tags[LIST_TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = blockIdx.x;
  const long long ce = p / a.live_tiles, t = p - ce * a.live_tiles;
  const int nce = (2 * a.E + 1) * a.MO;
  const int c = __ldg(a.row_counts + ce * a.ntile + t);
  if (c == 0) return;  // no row of this channel in the tile (block-uniform)
  int part = 0;  // this thread's share of the rows before the pair
  for (long long i = tid; i < t; i += EMIT_THREADS) part += __ldg(a.row_counts + ce * a.ntile + i);
  for (int i = tid; i < ce; i += EMIT_THREADS) part += __ldg(a.row_counts + nce * a.ntile + i);
  const int n_cand = __ldg(a.n_cand);
  const long long m0 = t * LIST_TILE + (long long)tid * EMIT_PER;
  const int2* dec = a.dec + ce * a.items;
  int2 dv[EMIT_PER];
  int mine = 0;
#pragma unroll
  for (int q = 0; q < EMIT_PER; ++q) {
    dv[q] = m0 + q < n_cand ? dec[m0 + q] : make_int2(0, -1);
    mine += dv[q].y >= 0;
  }
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += up;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xFFFFFFFFu, part, o);
  if (lane == 31) s_warp[warp] = incl;
  if (lane == 0) s_part[warp] = part;
  __syncthreads();  // the warps' row counts and shares of the pair's first row
  int rank = incl - mine;
  for (int v = 0; v < warp; ++v) rank += s_warp[v];
  long long base = 0;
#pragma unroll
  for (int v = 0; v < EMIT_THREADS / 32; ++v) base += s_part[v];
  const int b = (int)(ce / a.MO), o = (int)(ce - (long long)b * a.MO);
#pragma unroll
  for (int q = 0; q < EMIT_PER; ++q) {
    if (dv[q].y < 0) continue;
    const long long m = m0 + q;
    const int f = __ldg(a.cand_field + m);
    int32_t* r = s_rows + rank * 5;
    r[0] = __ldg(a.cand_start + m);
    r[1] = dv[q].x;
    r[2] = __ldg(a.depth + f) + (b - a.E);
    r[3] = __ldg(a.out_list + (long long)__ldg(a.node + f) * a.MO + o);
    r[4] = a.counts == nullptr ? dv[q].y : __ldg(a.counts + (long long)dv[q].y * a.counts_stride);
    if (a.tags != nullptr) s_tags[rank] = (int)ce * a.n_combo + __ldg(a.cand_combo + m);
    ++rank;
  }
  __syncthreads();
  // The pair's rows [base, base + c) are rows[5 base .. 5 (base + c)): the
  // words before the first 16-byte boundary one by one, then int4 stores.
  int32_t* dst = a.rows + 5 * base;
  const int words = 5 * c;
  const int head = min(words, (int)((4 - ((5 * base) & 3)) & 3));
  if (tid < head) dst[tid] = s_rows[tid];
  const int nvec = (words - head) / 4;
  for (int v = tid; v < nvec; v += EMIT_THREADS) {
    const int i = head + 4 * v;
    reinterpret_cast<int4*>(dst + i)[0] =
        make_int4(s_rows[i], s_rows[i + 1], s_rows[i + 2], s_rows[i + 3]);
  }
  for (int i = head + 4 * nvec + tid; i < words; i += EMIT_THREADS) dst[i] = s_rows[i];
  if (a.tags != nullptr)
    for (int i = tid; i < c; i += EMIT_THREADS) a.tags[base + i] = s_tags[i];
}

// Kernels whose shared memory passes 48 KiB must be allowed it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The blocks of ``k`` (``threads`` threads, ``shm`` bytes of shared memory)
// an SM holds at once. The answer is fixed per kernel and size, so the
// occupancy query runs once per (kernel, threads, bytes), not on every
// slice's launch.
template <typename K>
cudaError_t resident_per_sm(K k, int threads, size_t shm, int* per_sm) {
  struct Seen {
    const void* k;
    int threads;
    size_t shm;
    int per_sm;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  const void* key = reinterpret_cast<const void*>(k);
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& e : seen) {
    if (e.k == key && e.threads == threads && e.shm == shm) {
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  }
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, threads, shm);
  if (rc == cudaSuccess) seen.push_back(Seen{key, threads, shm, *per_sm});
  return rc;
}

// Launches kernel ``k`` of ``threads`` threads and ``groups`` candidates a
// block, sizing its shared memory; the grid is capped at BLOCKS_PER_SM
// blocks an SM, or with ``resident`` at the blocks the card holds at once
// (the rows DP, whose groups stride over the list without a barrier).
template <typename K>
cudaError_t launch_dp(K k, ListArgs a, int threads, int groups, cudaStream_t s,
                      bool resident = false) {
  const size_t rest = sizeof(int32_t) * (size_t)block_words(a, groups);
  const size_t sim = sim_smem_bytes(a.core.C, rest);
  a.sim_smem = sim != 0;
  const size_t shm = rest + sim;
  cudaError_t rc = allow_smem(k, shm);
  if (rc != cudaSuccess) return rc;
  int per_sm = BLOCKS_PER_SM;
  if (resident) {
    rc = resident_per_sm(k, threads, shm, &per_sm);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  long long blocks = (a.items + groups - 1) / groups;
  const long long cap = (long long)sm_count() * per_sm;
  if (blocks > cap) blocks = cap;
  k<<<(unsigned)blocks, threads, shm, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Candidates per row-count tile of the list step (a block of its emission
// takes one tile of one channel): the callers size row_counts (ntile =
// ceil(items / tile)).
int fac_count_tile() { return LIST_TILE; }

// The count-channel DP over a candidate list and its decisions.
// cand_field, cand_start: int32 [items], the first *n_cand (on the card)
// live; the DP tables, forbid and the map_* tables as fac_banded_dp takes
// them; node: int32 [F]; out_list: int32 [N, MO]; pat_len, pat_weight: f32
// [P]; dec: int32 [(2E+1) MO, items, 2] (columns past n_cand untouched);
// row_counts: int32 [nce * ntile + nce + 2], nce = (2E+1) MO, ntile =
// ceil(items / fac_count_tile()): zeroed, then the rows per (channel, tile),
// per channel after them and in all are added, and n_cand written last.
// Returns the launch's cudaError_t.
int fac_count_dp(const void* cand_field, const void* cand_start, const void* n_cand,
                 long long items, const void* ids, int ids_u8, long long npad, long long limit,
                 const void* path_cls, const void* path_node, const void* depth,
                 const void* node, int Lmax, int F, const void* sim, int C,
                 const void* node_ceil, const void* sb_edge, const void* out_count, int N,
                 const void* out_list, int MO, const void* pat_len, const void* pat_weight,
                 float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
                 float floor_, float bound, int E, int deadend, int forbid,
                 const void* map_tab, const void* map_rowptr, const void* map_fields,
                 int map_fw, void* dec, void* row_counts, long long ntile, void* stream) {
  const bool maps = map_tab != nullptr;
  if (items < 1 || E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 || MO < 1 ||
      (2 * E + 1) * MO > MAX_CHANNELS || limit < 0 || limit > npad || forbid < 0 ||
      forbid > 15 || (deadend && maps) ||
      (maps && (map_rowptr == nullptr || map_fields == nullptr || map_fw < (F + 31) / 32)) ||
      cand_field == nullptr || cand_start == nullptr || n_cand == nullptr || dec == nullptr ||
      row_counts == nullptr || ntile != (items + LIST_TILE - 1) / LIST_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  ListArgs a{};
  a.core.ids = ids;
  a.core.limit = limit;
  a.core.path_cls = static_cast<const int32_t*>(path_cls);
  a.core.path_node = static_cast<const int32_t*>(path_node);
  a.core.depth = static_cast<const int32_t*>(depth);
  a.core.Lmax = Lmax;
  a.core.sim = static_cast<const float*>(sim);
  a.core.C = C;
  a.core.node_ceil = static_cast<const float*>(node_ceil);
  a.core.sb_edge = static_cast<const int8_t*>(sb_edge);
  a.core.out_count = static_cast<const int32_t*>(out_count);
  a.core.max_pen = max_pen;
  a.core.p_sub = p_sub;
  a.core.p_ins = p_ins;
  a.core.p_del = p_del;
  a.core.p_swap = p_swap;
  a.core.floor_ = floor_;
  a.core.forbid = forbid;
  a.core.map_tab = static_cast<const int32_t*>(map_tab);
  a.core.map_rowptr = static_cast<const int32_t*>(map_rowptr);
  a.core.map_fields = static_cast<const int32_t*>(map_fields);
  a.core.map_fw = map_fw;
  a.ids_u8 = ids_u8 != 0;
  a.E = E;
  a.deadend = deadend != 0;
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.n_cand = static_cast<const int32_t*>(n_cand);
  a.items = items;
  a.emit.node = static_cast<const int32_t*>(node);
  a.emit.out_list = static_cast<const int32_t*>(out_list);
  a.emit.MO = MO;
  a.emit.pat_len = static_cast<const float*>(pat_len);
  a.emit.pat_weight = static_cast<const float*>(pat_weight);
  a.emit.bound = bound;
  a.dec = static_cast<int2*>(dec);
  a.row_counts = static_cast<int32_t*>(row_counts);
  a.ntile = ntile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(row_counts, 0,
                                   sizeof(int32_t) * ((2 * E + 1) * MO * (ntile + 1) + 2), s);
  if (rc != cudaSuccess) return (int)rc;
  const int cells = (2 * E + 1) * (E + 1);
  const int staged = staged_words(Lmax, E, a.deadend, MO);
  if (cells <= 32) {
    const int G = cells <= 8 ? 8 : cells <= 16 ? 16 : 32;
    a.lead_words = MAX_CHANNELS;
    a.group_words = staged + 2 * G;
    if (G == 8)
      rc = maps ? launch_dp(count_dp_kernel<8, true>, a, CL_THREADS, CL_THREADS / 8, s)
                : launch_dp(count_dp_kernel<8, false>, a, CL_THREADS, CL_THREADS / 8, s);
    else if (G == 16)
      rc = maps ? launch_dp(count_dp_kernel<16, true>, a, CL_THREADS, CL_THREADS / 16, s)
                : launch_dp(count_dp_kernel<16, false>, a, CL_THREADS, CL_THREADS / 16, s);
    else
      rc = maps ? launch_dp(count_dp_kernel<32, true>, a, CL_THREADS, CL_THREADS / 32, s)
                : launch_dp(count_dp_kernel<32, false>, a, CL_THREADS, CL_THREADS / 32, s);
  } else {
    a.lead_words = maps ? Lmax + 2 : 0;
    a.group_words = staged;
    constexpr int GR = CR_THREADS / CR_G;
    if (E == 4)
      rc = maps ? launch_dp(count_dp_rows_kernel<4, true>, a, CR_THREADS, GR, s, true)
                : launch_dp(count_dp_rows_kernel<4, false>, a, CR_THREADS, GR, s, true);
    else if (E == 5)
      rc = maps ? launch_dp(count_dp_rows_kernel<5, true>, a, CR_THREADS, GR, s, true)
                : launch_dp(count_dp_rows_kernel<5, false>, a, CR_THREADS, GR, s, true);
    else
      rc = maps ? launch_dp(count_dp_rows_kernel<6, true>, a, CR_THREADS, GR, s, true)
                : launch_dp(count_dp_rows_kernel<6, false>, a, CR_THREADS, GR, s, true);
  }
  return (int)rc;
}

// The emission of the list step and of the typed step. The candidate list
// (cand_combo too) and n_cand as fac_count_dp (fac_typed_dp) read them;
// depth, node: int32 [F]; out_list: int32 [N, MO]; counts: null for the
// list step, whose decisions hold the packed counts, or the typed step's
// packed-counts column of its graph (int32, counts_stride >= 1 apart, one
// per channel); dec and row_counts as fac_count_dp (fac_typed_dp) wrote
// them; rows: int32 [total, 5], 16-byte aligned; tags: int32 [total] or
// null. live: the candidates' total, which the host has read; the grid is a
// block per (channel, tile of them), (2E+1) MO x ceil(live /
// fac_count_tile()) blocks. Returns the launch's cudaError_t.
int fac_count_emit(const void* cand_field, const void* cand_start, const void* cand_combo,
                   const void* n_cand, long long items, long long live, const void* depth,
                   const void* node, const void* out_list, int MO, int E, int n_combo,
                   const void* counts, int counts_stride, const void* dec,
                   const void* row_counts, long long ntile, void* rows, void* tags,
                   void* stream) {
  if (items < 1 || MO < 1 || E < 1 || E > MAX_E || n_combo < 1 ||
      (2 * E + 1) * MO > MAX_CHANNELS || ntile != (items + LIST_TILE - 1) / LIST_TILE ||
      ntile > 0x7FFFFFFFll || rows == nullptr || live < 0 || live > items ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0 || row_counts == nullptr ||
      (counts != nullptr && counts_stride < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long live_tiles = (live + LIST_TILE - 1) / LIST_TILE;
  const long long blocks = (2 * E + 1) * MO * live_tiles;
  if (blocks == 0) return (int)cudaSuccess;
  EmitArgs a;
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.cand_combo = static_cast<const int32_t*>(cand_combo);
  a.n_cand = static_cast<const int32_t*>(n_cand);
  a.items = items;
  a.depth = static_cast<const int32_t*>(depth);
  a.node = static_cast<const int32_t*>(node);
  a.out_list = static_cast<const int32_t*>(out_list);
  a.MO = MO;
  a.E = E;
  a.n_combo = n_combo;
  a.counts = static_cast<const int32_t*>(counts);
  a.counts_stride = counts_stride;
  a.dec = static_cast<const int2*>(dec);
  a.row_counts = static_cast<const int32_t*>(row_counts);
  a.ntile = ntile;
  a.live_tiles = live_tiles;
  a.rows = static_cast<int32_t*>(rows);
  a.tags = static_cast<int32_t*>(tags);
  count_emit_kernel<<<(unsigned)blocks, EMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
