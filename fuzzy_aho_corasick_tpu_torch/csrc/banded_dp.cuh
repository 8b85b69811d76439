// Shared device code of the banded Damerau DP (see banded_dp.cu for what it
// computes and the semantics it keeps): the tables, the per-candidate DP
// body, the similarity-table staging and the emission test. Included by
// banded_dp.cu (the DP alone, channel outputs), dp_pipeline.cu (expansion,
// DP and emission in one kernel) and many_step.cu (the large-dictionary
// lane's sparse expansion, DP and emission in one kernel), so all run the
// same body.
//
// Two options of the JAX package's _banded_dp ride the same body:
//   * FORBID (verify_dp.py:355-363): edit types capped at 0 lose their
//     arrivals, the deletions also the emission channel's trailing deletion.
//     A mask in DpCore, tested where each arrival's guard starts; every
//     thread of a launch sees the same mask, so no warp diverges on it and
//     no instance is added.
//   * MAPS (verify_dp.py:365-376, 611-655): mapping arrivals
//     (row i-pb, band b-drift) -> (row i, band b). A template parameter:
//     they need row i-3 and two more window symbols on the left, registers
//     the other instances must not pay.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fac_dp {

constexpr int DP_THREADS = 128;
constexpr int MAX_E = 6;
constexpr int SIM_SMEM_MAX = 48 * 1024;

struct DpCore {
  const void* ids;            // dense class ids, u8 or int32 [npad]
  long long limit;            // positions >= limit are out of text
  const int32_t* path_cls;    // [F, Lmax]
  const int32_t* path_node;   // [F, Lmax]
  const int32_t* depth;       // [F]
  int Lmax;
  const float* sim;           // [C, C]
  int C;
  const float* node_ceil;     // [N]
  const int8_t* sb_edge;      // [N, C] (DEADEND)
  const int32_t* out_count;   // [N] (DEADEND)
  float max_pen, p_sub, p_ins, p_del, p_swap, floor_;
  int forbid;                 // bit 0 no insertions, 1 no deletions, 2 no substitutions, 3 no swaps
  // MAPS: the mapping arrivals, sorted by target row.
  const int32_t* map_tab;     // [n, MAP_COLS]: i_to, pb, drift, ha, the ha classes
                              // last-consumed first (4, -2 padded), penalty f32 bits
  const int32_t* map_rowptr;  // [Lmax + 2]: row i's entries are rowptr[i] .. rowptr[i + 1]
  const int32_t* map_fields;  // [n, map_fw]: bit (f & 31) of word (f >> 5): entry applies to field f
  int map_fw;
};

constexpr int MAP_COLS = 9;
constexpr int MAP_HA_MAX = 4;  // haystack symbols one mapping arrival may consume

template <typename Sym>
__device__ __forceinline__ int hay_at(const Sym* ids, long long p, long long limit) {
  return (p >= 0 && p < limit) ? (int)__ldg(ids + p) : -1;
}

__device__ __forceinline__ bool fin(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);  // false for +-inf and NaN
}

// Strictly-lower merge: the earlier arrival wins ties.
__device__ __forceinline__ void merge(float& bp, int& bc, float op, int oc, bool ok) {
  if (ok && op < bp) {
    bp = op;
    bc = oc;
  }
}

// Bytes of dynamic shared memory the similarity table takes beside a
// kernel's ``static_bytes`` of static shared memory (0: read it through the
// read-only cache instead; a block takes 48 KiB in all without an opt-in).
inline size_t sim_smem_bytes(int C, size_t static_bytes = 0) {
  const size_t bytes = (size_t)C * C * sizeof(float);
  return bytes + static_bytes <= (size_t)SIM_SMEM_MAX ? bytes : 0;
}

// Every thread of the block calls this before any of them leaves.
__device__ __forceinline__ void load_sim(const DpCore& a, float* s_sim, bool sim_smem) {
  if (sim_smem) {
    for (int t = threadIdx.x; t < a.C * a.C; t += DP_THREADS) s_sim[t] = a.sim[t];
    __syncthreads();
  }
}

// Cell (b - drift, e) of a row, for the static (b, e) of an unrolled loop and
// a drift of -1, 0 or 1 known at run time; the caller has checked the band.
template <int B, int NE, typename V>
__device__ __forceinline__ V drift_pick(const V (&row)[B][NE], int b, int e, int drift) {
  return drift == 0 ? row[b][e] : drift > 0 ? row[b > 0 ? b - 1 : 0][e]
                                            : row[b + 1 < B ? b + 1 : B - 1][e];
}

// The DP of one candidate (field f >= 0, start s): fills the emission
// channel at row depth(f), emit_pen / emit_cnt [B][NE] (+inf where dead).
template <int E, bool DEADEND, bool MAPS, typename Sym>
__device__ __forceinline__ void dp_body(const DpCore& a, const float* s_sim,
                                        bool sim_smem, int f, long long s,
                                        float (&emit_pen)[2 * E + 1][E + 1],
                                        int (&emit_cnt)[2 * E + 1][E + 1]) {
  constexpr int B = 2 * E + 1;
  constexpr int NE = E + 1;
  const float INF = __int_as_float(0x7f800000);
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      emit_pen[b][e] = INF;
      emit_cnt[b][e] = 0;
    }
  const Sym* ids = static_cast<const Sym*>(a.ids);
  const int d = __ldg(a.depth + f);
    const int* pcls = a.path_cls + (long long)f * a.Lmax;
  const int* pnode = a.path_node + (long long)f * a.Lmax;
  const float max_pen = a.max_pen;
  const bool no_ins = a.forbid & 1, no_del = a.forbid & 2, no_sub = a.forbid & 4,
             no_swap = a.forbid & 8;

  // Rows i-1 (prev), i-2 (prev2) and the emission channel of row i-1
  // (preve). Row 0 is the origin (band E, no edits); row -1 is dead.
  float prev_pen[B][NE], prev2_pen[B][NE], preve_pen[B][NE];
  int prev_cnt[B][NE], prev2_cnt[B][NE], preve_cnt[B][NE];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      prev_pen[b][e] = prev2_pen[b][e] = preve_pen[b][e] = INF;
      prev_cnt[b][e] = prev2_cnt[b][e] = preve_cnt[b][e] = 0;
    }
  prev_pen[E][0] = 0.f;
  preve_pen[E][0] = 0.f;
  // Row i-3, which only a mapping arrival with pb = 3 reads.
  float prev3_pen[MAPS ? B : 1][NE];
  int prev3_cnt[MAPS ? B : 1][NE];
  if constexpr (MAPS) {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        prev3_pen[b][e] = INF;
        prev3_cnt[b][e] = 0;
      }
  }

  // Haystack window of row i: w[WL + t] = hay(s + i - E - 2 + t), t = 0..B+1,
  // so hc(b) = w[WL+b+1], hc_jm1(b) = w[WL+b], the next char (DEADEND)
  // w[WL+b+2]. A mapping arrival into band 0 that consumes MAP_HA_MAX symbols
  // reads WL = MAP_HA_MAX - 2 symbols further left.
  constexpr int WL = MAPS ? MAP_HA_MAX - 2 : 0;
  constexpr int WN = B + 2 + WL;
  int w[WN];
#pragma unroll
  for (int t = 0; t < WN; ++t) w[t] = hay_at(ids, s - E - 1 - WL + t, a.limit);

#pragma unroll 1
  for (int i = 1; i <= d; ++i) {
    const int pc = __ldg(pcls + i - 1);
    const int pc_prev = __ldg(pcls + (i >= 2 ? i - 2 : 0));
    const int pn = __ldg(pnode + i - 1);
    const float ceil_i = __ldg(a.node_ceil + pn);
    bool okrow[B];
    if constexpr (DEADEND) {
      const bool has_out = __ldg(a.out_count + pn) > 0;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int nxt = w[WL + b + 2];
        okrow[b] = has_out ||
                   (nxt >= 0 && __ldg(a.sb_edge + (long long)pn * a.C + nxt) > 0);
      }
    }

    float cons_pen[B][NE], new_pen[B][NE];
    int cons_cnt[B][NE], new_cnt[B][NE];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = i + b - E;  // haystack symbols consumed at this cell
      const int hc = w[WL + b + 1];
      const int hc_jm1 = w[WL + b];
      float sim = 0.f;
      if (hc >= 0) {
        const int k = pc * a.C + hc;
        sim = sim_smem ? s_sim[k] : __ldg(a.sim + k);
      }
      const float spen = __fmul_rn(a.p_sub, __fsub_rn(1.f, sim));
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        // exact: (i-1, b, e), no edit
        const float p = prev_pen[b][e];
        float bp = (j >= 1 && fin(p) && hc == pc) ? p : INF;
        int bc = prev_cnt[b][e];
        if (e >= 1) {
          // substitution: (i-1, b, e-1)
          const float q = prev_pen[b][e - 1];
          bool ok_s = !no_sub && j >= 1 && fin(q) && hc >= 0 && hc != pc &&
                      !(sim < a.floor_) && !(spen > __fsub_rn(max_pen, q));
          if (DEADEND && e == NE - 1) ok_s = ok_s && okrow[b];
          merge(bp, bc, __fadd_rn(q, spen), prev_cnt[b][e - 1] + 0x10000, ok_s);
          // swap: (i-2, b, e-1)
          const float sw = prev2_pen[b][e - 1];
          const bool ok_sw = !no_swap && i >= 2 && j >= 2 && fin(sw) &&
                             !(a.p_swap > __fsub_rn(max_pen, sw)) && hc >= 0 &&
                             hc_jm1 >= 0 && hc == pc_prev && hc_jm1 == pc;
          merge(bp, bc, __fadd_rn(sw, a.p_swap), prev2_cnt[b][e - 1] + 0x1000000, ok_sw);
        }
        cons_pen[b][e] = bp;
        cons_cnt[b][e] = bc;
        if (e >= 1 && b + 1 < B) {
          // deletion: (i-1, b+1, e-1), consumes pc only
          const float dl = prev_pen[b + 1][e - 1];
          bool ok_d = !no_del && fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl));
          if (DEADEND && e == NE - 1) ok_d = ok_d && okrow[b];
          merge(bp, bc, __fadd_rn(dl, a.p_del), prev_cnt[b + 1][e - 1] + 0x100, ok_d);
        }
        new_pen[b][e] = bp;
        new_cnt[b][e] = bc;
      }
    }

    // Mapping arrivals targeting row i, in the table's order (the oracle's
    // push order): from (row i-pb, band b-drift), consuming ha symbols that
    // must equal the entry's classes (out of text reads -1, never a class),
    // at a fixed penalty, one substitution counted. A consuming move: merged
    // into the consuming and the continuation channel. The guard is the
    // oracle's at push time, (q + mp) > max_pen, not the x > max_pen - q of
    // the other arrivals.
    if constexpr (MAPS) {
      const int m1 = __ldg(a.map_rowptr + i + 1);
#pragma unroll 1
      for (int mi = __ldg(a.map_rowptr + i); mi < m1; ++mi) {
        const int32_t* me = a.map_tab + (long long)mi * MAP_COLS;
        const int pb = __ldg(me + 1);
        if (i - pb < 0) continue;
        const int fw = __ldg(a.map_fields + (long long)mi * a.map_fw + (f >> 5));
        if (!((fw >> (f & 31)) & 1)) continue;
        const int drift = __ldg(me + 2), ha = __ldg(me + 3);
        int hr[MAP_HA_MAX];
#pragma unroll
        for (int u = 0; u < MAP_HA_MAX; ++u) hr[u] = __ldg(me + 4 + u);
        const float mp = __int_as_float(__ldg(me + 8));
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int bs = b - drift;
          bool ok_m = bs >= 0 && bs < B && i + b - E >= ha;
#pragma unroll
          for (int u = 0; u < MAP_HA_MAX; ++u)
            ok_m = ok_m && (u >= ha || w[WL + b + 1 - u] == hr[u]);
          if (!ok_m) continue;
#pragma unroll
          for (int e = 1; e < NE; ++e) {
            const float q = pb == 1   ? drift_pick<B, NE>(prev_pen, b, e - 1, drift)
                            : pb == 2 ? drift_pick<B, NE>(prev2_pen, b, e - 1, drift)
                                      : drift_pick<B, NE>(prev3_pen, b, e - 1, drift);
            const int qc = pb == 1   ? drift_pick<B, NE>(prev_cnt, b, e - 1, drift)
                           : pb == 2 ? drift_pick<B, NE>(prev2_cnt, b, e - 1, drift)
                                     : drift_pick<B, NE>(prev3_cnt, b, e - 1, drift);
            const float val = __fadd_rn(q, mp);
            const bool ok_e = fin(q) && !(val > max_pen);
            merge(cons_pen[b][e], cons_cnt[b][e], val, qc + 0x10000, ok_e);
            merge(new_pen[b][e], new_cnt[b][e], val, qc + 0x10000, ok_e);
          }
        }
      }
    }

    // insertion: same row, (b-1, e-1) -> b, ascending b over the updated
    // band b-1; none from cells with zero hay consumed (j - 1 >= 1).
#pragma unroll
    for (int b = 1; b < B; ++b) {
      const int j = i + b - E;
      const int hc = w[WL + b + 1];
#pragma unroll
      for (int e = 1; e < NE; ++e) {
        const float ip = new_pen[b - 1][e - 1];
        bool ok_i = !no_ins && j >= 2 && hc >= 0 && fin(ip) &&
                    !(a.p_ins > __fsub_rn(max_pen, ip));
        if (DEADEND && e == NE - 1) ok_i = ok_i && okrow[b];
        merge(new_pen[b][e], new_cnt[b][e], __fadd_rn(ip, a.p_ins),
              new_cnt[b - 1][e - 1] + 1, ok_i);
      }
    }

    // Ceiling, emission channel, latch at i == depth.
    float newe_pen[B][NE];
    int newe_cnt[B][NE];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (new_pen[b][e] > ceil_i) new_pen[b][e] = INF;
        float ep = cons_pen[b][e];
        int ec = cons_cnt[b][e];
        if (e >= 1 && b + 1 < B) {
          const float t = preve_pen[b + 1][e - 1];
          bool ok_t = !no_del && fin(t) && !(a.p_del > __fsub_rn(max_pen, t));
          if (DEADEND && e == NE - 1) ok_t = ok_t && okrow[b];
          merge(ep, ec, __fadd_rn(t, a.p_del), preve_cnt[b + 1][e - 1] + 0x100, ok_t);
        }
        newe_pen[b][e] = ep > ceil_i ? INF : ep;
        newe_cnt[b][e] = ec;
      }
    const bool emit_here = i == d;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (emit_here) {
          emit_pen[b][e] = newe_pen[b][e];
          emit_cnt[b][e] = newe_cnt[b][e];
        }
        if constexpr (MAPS) {
          prev3_pen[b][e] = prev2_pen[b][e];
          prev3_cnt[b][e] = prev2_cnt[b][e];
        }
        prev2_pen[b][e] = prev_pen[b][e];
        prev2_cnt[b][e] = prev_cnt[b][e];
        prev_pen[b][e] = new_pen[b][e];
        prev_cnt[b][e] = new_cnt[b][e];
        preve_pen[b][e] = newe_pen[b][e];
        preve_cnt[b][e] = newe_cnt[b][e];
      }
#pragma unroll
    for (int t = 0; t < WN - 1; ++t) w[t] = w[t + 1];
    w[WN - 1] = hay_at(ids, s + i + E + 1, a.limit);
  }
}

// The emission's tables (verify_dp.py::emit_rows).
struct EmitTables {
  const int32_t* node;      // [F] output node of each field
  const int32_t* out_list;  // [N, MO] patterns of each node, -1 padded
  int MO;
  const float* pat_len;     // [P]
  const float* pat_weight;  // [P]
  float bound;              // threshold less the emission slack
};

// Per band the minimum over the NE edit channels, strict <: the lowest edit
// count wins penalty ties.
template <int E>
__device__ __forceinline__ void band_minimum(const float (&emit_pen)[2 * E + 1][E + 1],
                                             const int (&emit_cnt)[2 * E + 1][E + 1],
                                             float (&pen_best)[2 * E + 1],
                                             int (&cnt_best)[2 * E + 1]) {
#pragma unroll
  for (int b = 0; b < 2 * E + 1; ++b) {
    float pb = emit_pen[b][0];
    int cb = emit_cnt[b][0];
#pragma unroll
    for (int e = 1; e < E + 1; ++e) {
      if (emit_pen[b][e] < pb) {
        pb = emit_pen[b][e];
        cb = emit_cnt[b][e];
      }
    }
    pen_best[b] = pb;
    cnt_best[b] = cb;
  }
}

// Whether emission channel (band b, output slot o) of a live candidate
// (start, field depth d, output node) with band penalty pb emits, and its
// pattern: a finite penalty, the span inside [start, limit], a pattern in
// the slot, and the f32 similarity test ((pl - pb) / pl) * pw >= bound, each
// step rounded as written (the build adds -fmad=false).
__device__ __forceinline__ bool emits(const EmitTables& t, long long limit, int E, int start,
                                      int d, int node, int b, float pb, int o, int& pat) {
  pat = -1;
  if (!fin(pb)) return false;
  const int ends_b = start + d + (b - E);
  if (ends_b > limit || ends_b < start) return false;
  pat = __ldg(t.out_list + (long long)node * t.MO + o);
  if (pat < 0) return false;
  const float pl = __ldg(t.pat_len + pat);
  const float sim = __fmul_rn(__fdiv_rn(__fsub_rn(pl, pb), pl), __ldg(t.pat_weight + pat));
  return sim >= t.bound;
}

}  // namespace fac_dp
