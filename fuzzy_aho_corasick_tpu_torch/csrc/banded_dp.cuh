// Shared device code of the banded Damerau DP (see banded_dp.cu for what it
// computes and the semantics it keeps): the tables, the per-candidate DP
// body, and the similarity-table staging. Included by banded_dp.cu (the DP
// alone, channel outputs) and dp_pipeline.cu (expansion, DP and emission in
// one kernel), so both run the same body.

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
};

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

// Bytes of dynamic shared memory the similarity table takes (0: read it
// through the read-only cache instead).
inline size_t sim_smem_bytes(int C) {
  const size_t bytes = (size_t)C * C * sizeof(float);
  return bytes <= (size_t)SIM_SMEM_MAX ? bytes : 0;
}

// Every thread of the block calls this before any of them leaves.
__device__ __forceinline__ void load_sim(const DpCore& a, float* s_sim, bool sim_smem) {
  if (sim_smem) {
    for (int t = threadIdx.x; t < a.C * a.C; t += DP_THREADS) s_sim[t] = a.sim[t];
    __syncthreads();
  }
}

// The DP of one candidate (field f >= 0, start s): fills the emission
// channel at row depth(f), emit_pen / emit_cnt [B][NE] (+inf where dead).
template <int E, bool DEADEND, typename Sym>
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

  // Haystack window of row i: w[t] = hay(s + i - E - 2 + t), t = 0..B+1,
  // so hc(b) = w[b+1], hc_jm1(b) = w[b], the next char (DEADEND) w[b+2].
  int w[B + 2];
#pragma unroll
  for (int t = 0; t < B + 2; ++t) w[t] = hay_at(ids, s - E - 1 + t, a.limit);

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
        const int nxt = w[b + 2];
        okrow[b] = has_out ||
                   (nxt >= 0 && __ldg(a.sb_edge + (long long)pn * a.C + nxt) > 0);
      }
    }

    float cons_pen[B][NE], new_pen[B][NE];
    int cons_cnt[B][NE], new_cnt[B][NE];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = i + b - E;  // haystack symbols consumed at this cell
      const int hc = w[b + 1];
      const int hc_jm1 = w[b];
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
          bool ok_s = j >= 1 && fin(q) && hc >= 0 && hc != pc &&
                      !(sim < a.floor_) && !(spen > __fsub_rn(max_pen, q));
          if (DEADEND && e == NE - 1) ok_s = ok_s && okrow[b];
          merge(bp, bc, __fadd_rn(q, spen), prev_cnt[b][e - 1] + 0x10000, ok_s);
          // swap: (i-2, b, e-1)
          const float sw = prev2_pen[b][e - 1];
          const bool ok_sw = i >= 2 && j >= 2 && fin(sw) &&
                             !(a.p_swap > __fsub_rn(max_pen, sw)) && hc >= 0 &&
                             hc_jm1 >= 0 && hc == pc_prev && hc_jm1 == pc;
          merge(bp, bc, __fadd_rn(sw, a.p_swap), prev2_cnt[b][e - 1] + 0x1000000, ok_sw);
        }
        cons_pen[b][e] = bp;
        cons_cnt[b][e] = bc;
        if (e >= 1 && b + 1 < B) {
          // deletion: (i-1, b+1, e-1), consumes pc only
          const float dl = prev_pen[b + 1][e - 1];
          bool ok_d = fin(dl) && !(a.p_del > __fsub_rn(max_pen, dl));
          if (DEADEND && e == NE - 1) ok_d = ok_d && okrow[b];
          merge(bp, bc, __fadd_rn(dl, a.p_del), prev_cnt[b + 1][e - 1] + 0x100, ok_d);
        }
        new_pen[b][e] = bp;
        new_cnt[b][e] = bc;
      }
    }

    // insertion: same row, (b-1, e-1) -> b, ascending b over the updated
    // band b-1; none from cells with zero hay consumed (j - 1 >= 1).
#pragma unroll
    for (int b = 1; b < B; ++b) {
      const int j = i + b - E;
      const int hc = w[b + 1];
#pragma unroll
      for (int e = 1; e < NE; ++e) {
        const float ip = new_pen[b - 1][e - 1];
        bool ok_i = j >= 2 && hc >= 0 && fin(ip) &&
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
          bool ok_t = fin(t) && !(a.p_del > __fsub_rn(max_pen, t));
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
        prev2_pen[b][e] = prev_pen[b][e];
        prev2_cnt[b][e] = prev_cnt[b][e];
        prev_pen[b][e] = new_pen[b][e];
        prev_cnt[b][e] = new_cnt[b][e];
        preve_pen[b][e] = newe_pen[b][e];
        preve_cnt[b][e] = newe_cnt[b][e];
      }
#pragma unroll
    for (int t = 0; t < B + 1; ++t) w[t] = w[t + 1];
    w[B + 1] = hay_at(ids, s + i + E + 1, a.limit);
  }
}

}  // namespace fac_dp
