// Banded Damerau DP over fuzzy candidates, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_banded_dp (count channels; no
// mapping arrivals, no forbidden edit types), which XLA compiled from an
// unrolled graph of Lmax x B x NE vector ops. Its plain torch version is
// ops/verify_dp.py::banded_dp_torch; the wrapper is verify_dp.banded_dp.
//
// What it computes. For each candidate m = (field f, start s) it runs the
// banded weighted edit distance between the field's trie path (class ids
// path_cls[f, 0..depth)) and the haystack from s, over B = 2E+1 diagonals
// (band b <-> column j = i + b - E at row i) and NE = E+1 edit-count
// channels, with two channels per cell: the continuation channel ``pen``
// and the emission channel ``pen_e`` (consuming arrival, or trailing
// deletions after one). Outputs, at row i = depth: pen_out[b*NE + e][m]
// (f32, +inf when dead) and cnt_out[b*NE + e][m] (int32 edit types packed as
// ins | del << 8 | sub << 16 | swap << 24).
//
// Semantics kept exactly (checklist, verify_dp.py:536-709):
//   * f32 order: spen = p_sub * (1 - sim); sums q + p; guards written
//     x > (max_pen - q), never q + x > max_pen. Every operation is an
//     explicit __fadd_rn / __fsub_rn / __fmul_rn, and the file is built with
//     -fmad=false, so nothing is contracted into an FMA.
//   * merge order and ties: exact, then substitution, then swap go into the
//     consuming channel; then deletion into the continuation channel. A
//     merge takes the new value only when strictly lower, so the earlier
//     arrival wins ties. The count rides with the exact arrival's source
//     cell even when that cell is dead, as in JAX (it is only ever read
//     beside a +inf penalty then).
//   * insertions chain within a row: ascending b, reading the
//     already-updated new[b-1][e-1]; they need j >= 2 and hc >= 0.
//   * per-node ceiling and row liveness (verify_dp.py:681-698), applied
//     after the insertions, to the continuation and emission channels.
//   * emission channel: the consuming arrival, or the trailing deletion from
//     the previous row's emission channel at band b+1; latched at i == depth.
//   * swap guard: i >= 2, j >= 2, both symbols in text, hc == pc_prev and
//     hc_jm1 == pc.
//   * dead-end rescue (DEADEND): an edit move into the last edit level
//     survives only where the node at row i has output or a single-byte
//     edge matching the next text char (verify_dp.py:496-522).
//   * out-of-text symbols (position < 0 or >= limit) read as -1 and never
//     take part in a substitution; sim is read only when hc >= 0.
//   * dead candidates (field -1) emit +inf and count 0 everywhere.
//
// What bounds it on the H100. Latency per candidate: about depth x B x NE
// cell updates, each a few f32 compares and adds on registers, plus one
// pass over a window of about depth + 2E + 2 haystack symbols, a sim lookup
// per band and three small table reads per row. There is no reuse between
// candidates beyond the tables, and the candidate count per search is
// ~1e4-1e6, so the kernel is bound by per-thread dependent instruction
// latency, not by bytes. Its design: one thread per candidate; a template on
// E makes every [B][NE] cell of rows i-1 and i-2, of the emission channel
// and of the latched output a statically indexed register (spills at large E
// are accepted); the haystack window slides through B + 2 registers, one new
// u8 (or int32) read per row, straight from the dense id stream (the TPU's
// two-row u32 fetch and class-select similarity band were gather
// workarounds); the [C, C] similarity table sits in shared memory when it
// fits in 48 KiB, else it is read through the read-only cache, as are the
// per-field path classes, nodes, ceilings and depth. The loop runs rows
// 1..depth(field), not Lmax. Outputs are written [row][m], coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DP_THREADS = 128;
constexpr int MAX_E = 6;
constexpr int SIM_SMEM_MAX = 48 * 1024;

struct DpArgs {
  const int32_t* cand_field;  // [M], -1 = dead slot
  const int32_t* cand_start;  // [M]
  long long M;
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
  float* pen_out;             // [B * NE, M]
  int32_t* cnt_out;           // [B * NE, M]
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

template <int E, bool DEADEND, typename Sym>
__global__ void __launch_bounds__(DP_THREADS)
banded_dp_kernel(DpArgs a, bool sim_smem) {
  constexpr int B = 2 * E + 1;
  constexpr int NE = E + 1;
  const float INF = __int_as_float(0x7f800000);
  extern __shared__ float s_sim[];

  if (sim_smem) {
    for (int t = threadIdx.x; t < a.C * a.C; t += DP_THREADS) s_sim[t] = a.sim[t];
    __syncthreads();
  }
  const long long m = (long long)blockIdx.x * DP_THREADS + threadIdx.x;
  if (m >= a.M) return;

  float emit_pen[B][NE];
  int emit_cnt[B][NE];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      emit_pen[b][e] = INF;
      emit_cnt[b][e] = 0;
    }

  const int f = __ldg(a.cand_field + m);
  if (f >= 0) {
    const Sym* ids = static_cast<const Sym*>(a.ids);
    const int d = __ldg(a.depth + f);
    const long long s = __ldg(a.cand_start + m);
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

#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const long long o = (long long)(b * NE + e) * a.M + m;
      a.pen_out[o] = emit_pen[b][e];
      a.cnt_out[o] = emit_cnt[b][e];
    }
}

template <int E>
cudaError_t launch_e(const DpArgs& a, bool deadend, bool u8, cudaStream_t stream) {
  const long long blocks = (a.M + DP_THREADS - 1) / DP_THREADS;
  const size_t sim_bytes = (size_t)a.C * a.C * sizeof(float);
  const bool smem = sim_bytes <= SIM_SMEM_MAX;
  const size_t shm = smem ? sim_bytes : 0;
  const unsigned g = (unsigned)blocks;
  if (deadend) {
    if (u8)
      banded_dp_kernel<E, true, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
    else
      banded_dp_kernel<E, true, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
  } else {
    if (u8)
      banded_dp_kernel<E, false, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
    else
      banded_dp_kernel<E, false, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cand_field, cand_start: int32 [M]; ids: u8 (ids_u8 = 1) or int32 [npad];
// path_cls, path_node: int32 [F, Lmax]; depth: int32 [F]; sim: f32 [C, C];
// node_ceil: f32 [N]; sb_edge: int8 [N, C]; out_count: int32 [N];
// pen: f32 [(2E+1)(E+1), M]; cnt: int32 [(2E+1)(E+1), M]. Returns the
// launch's cudaError_t (0 = launched).
int fac_banded_dp(const void* cand_field, const void* cand_start, long long M,
                  const void* ids, int ids_u8, long long npad, long long limit,
                  const void* path_cls, const void* path_node, const void* depth,
                  int Lmax, int F, const void* sim, int C, const void* node_ceil,
                  const void* sb_edge, const void* out_count, int N,
                  float max_pen, float p_sub, float p_ins, float p_del,
                  float p_swap, float floor_, int E, int deadend, void* pen,
                  void* cnt, void* stream) {
  if (M < 1 || E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 ||
      limit < 0 || limit > npad) {
    return (int)cudaErrorInvalidValue;
  }
  DpArgs a;
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.M = M;
  a.ids = ids;
  a.limit = limit;
  a.path_cls = static_cast<const int32_t*>(path_cls);
  a.path_node = static_cast<const int32_t*>(path_node);
  a.depth = static_cast<const int32_t*>(depth);
  a.Lmax = Lmax;
  a.sim = static_cast<const float*>(sim);
  a.C = C;
  a.node_ceil = static_cast<const float*>(node_ceil);
  a.sb_edge = static_cast<const int8_t*>(sb_edge);
  a.out_count = static_cast<const int32_t*>(out_count);
  a.max_pen = max_pen;
  a.p_sub = p_sub;
  a.p_ins = p_ins;
  a.p_del = p_del;
  a.p_swap = p_swap;
  a.floor_ = floor_;
  a.pen_out = static_cast<float*>(pen);
  a.cnt_out = static_cast<int32_t*>(cnt);
  const bool de = deadend != 0, u8 = ids_u8 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1: return (int)launch_e<1>(a, de, u8, s);
    case 2: return (int)launch_e<2>(a, de, u8, s);
    case 3: return (int)launch_e<3>(a, de, u8, s);
    case 4: return (int)launch_e<4>(a, de, u8, s);
    case 5: return (int)launch_e<5>(a, de, u8, s);
    case 6: return (int)launch_e<6>(a, de, u8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
