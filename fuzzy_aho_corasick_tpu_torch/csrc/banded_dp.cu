// Banded Damerau DP over fuzzy candidates, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_banded_dp (count channels, with
// its FORBID and MAPS options: see banded_dp.cuh), which XLA compiled from an
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

#include "banded_dp.cuh"

namespace {

using namespace fac_dp;

struct DpArgs {
  DpCore core;
  const int32_t* cand_field;  // [M], -1 = dead slot
  const int32_t* cand_start;  // [M]
  long long M;
  float* pen_out;             // [B * NE, M]
  int32_t* cnt_out;           // [B * NE, M]
};

template <int E, bool DEADEND, bool MAPS, typename Sym>
__global__ void __launch_bounds__(DP_THREADS)
banded_dp_kernel(DpArgs a, bool sim_smem) {
  constexpr int B = 2 * E + 1;
  constexpr int NE = E + 1;
  extern __shared__ float s_sim[];

  load_sim(a.core, s_sim, sim_smem);
  const long long m = (long long)blockIdx.x * DP_THREADS + threadIdx.x;
  if (m >= a.M) return;

  float emit_pen[B][NE];
  int emit_cnt[B][NE];
  const int f = __ldg(a.cand_field + m);
  if (f >= 0) {
    dp_body<E, DEADEND, MAPS, Sym>(a.core, s_sim, sim_smem, f, __ldg(a.cand_start + m),
                             emit_pen, emit_cnt);
  } else {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        emit_pen[b][e] = __int_as_float(0x7f800000);
        emit_cnt[b][e] = 0;
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

// The mapped lane has no multi-byte edges, so MAPS and DEADEND never meet.
template <int E>
cudaError_t launch_e(const DpArgs& a, bool deadend, bool maps, bool u8, cudaStream_t stream) {
  const long long blocks = (a.M + DP_THREADS - 1) / DP_THREADS;
  const size_t shm = sim_smem_bytes(a.core.C);
  const bool smem = shm != 0;
  const unsigned g = (unsigned)blocks;
  if (deadend && maps) return cudaErrorInvalidValue;
  if (deadend) {
    if (u8)
      banded_dp_kernel<E, true, false, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
    else
      banded_dp_kernel<E, true, false, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
  } else if (maps) {
    if (u8)
      banded_dp_kernel<E, false, true, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
    else
      banded_dp_kernel<E, false, true, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
  } else {
    if (u8)
      banded_dp_kernel<E, false, false, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
    else
      banded_dp_kernel<E, false, false, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cand_field, cand_start: int32 [M]; ids: u8 (ids_u8 = 1) or int32 [npad];
// path_cls, path_node: int32 [F, Lmax]; depth: int32 [F]; sim: f32 [C, C];
// node_ceil: f32 [N]; sb_edge: int8 [N, C]; out_count: int32 [N];
// forbid: the edit types switched off (DpCore::forbid); map_tab int32
// [n, 9], map_rowptr int32 [Lmax + 2], map_fields int32 [n, map_fw]: the
// mapping arrivals, all null without mappings;
// pen: f32 [(2E+1)(E+1), M]; cnt: int32 [(2E+1)(E+1), M]. Returns the
// launch's cudaError_t (0 = launched).
int fac_banded_dp(const void* cand_field, const void* cand_start, long long M,
                  const void* ids, int ids_u8, long long npad, long long limit,
                  const void* path_cls, const void* path_node, const void* depth,
                  int Lmax, int F, const void* sim, int C, const void* node_ceil,
                  const void* sb_edge, const void* out_count, int N,
                  float max_pen, float p_sub, float p_ins, float p_del,
                  float p_swap, float floor_, int E, int deadend, int forbid,
                  const void* map_tab, const void* map_rowptr, const void* map_fields,
                  int map_fw, void* pen, void* cnt, void* stream) {
  if (M < 1 || E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 ||
      limit < 0 || limit > npad || forbid < 0 || forbid > 15 ||
      (map_tab != nullptr && (map_rowptr == nullptr || map_fields == nullptr ||
                              map_fw < (F + 31) / 32))) {
    return (int)cudaErrorInvalidValue;
  }
  DpArgs a;
  a.cand_field = static_cast<const int32_t*>(cand_field);
  a.cand_start = static_cast<const int32_t*>(cand_start);
  a.M = M;
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
  a.pen_out = static_cast<float*>(pen);
  a.cnt_out = static_cast<int32_t*>(cnt);
  const bool de = deadend != 0, mp = map_tab != nullptr, u8 = ids_u8 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1: return (int)launch_e<1>(a, de, mp, u8, s);
    case 2: return (int)launch_e<2>(a, de, mp, u8, s);
    case 3: return (int)launch_e<3>(a, de, mp, u8, s);
    case 4: return (int)launch_e<4>(a, de, mp, u8, s);
    case 5: return (int)launch_e<5>(a, de, mp, u8, s);
    case 6: return (int)launch_e<6>(a, de, mp, u8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
