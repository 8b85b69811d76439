// Candidate expansion, banded Damerau DP and emission of one corpus slice
// as one kernel, for Hopper (sm_90a), at E = 1 without forbidden edit types
// or mappings (the fuzzy1 engines, with or without the dead-end filter).
//
// Replaces the device body of the JAX package's one-dispatch pipeline
// fuzzy_aho_corasick_tpu/ops/verify_dp.py::_dp_pipeline_jit behind the scan
// for those engines: _expand_candidates, _banded_dp and _emit_rows, which
// XLA fused from whole-array ops with static capacities. Its plain torch
// version is ops/verify_dp.py::dp_pipeline_torch (expand_candidates ->
// banded_dp_torch -> emit_rows); the wrapper is verify_dp.dp_pipeline. Every
// other count-channel engine (E >= 2, a forbid mask, mapping arrivals) runs
// the list step of dp_list.cu; the typed lane's counterpart is dp_typed.cu,
// the large-dictionary lane's many_step.cu.
//
// What it computes. The grid is the uncompacted (combo, hit) product,
// combo-major: item g = c * (K - h0) + h - h0 pairs combo c = (pattern bit,
// field, band) with hit h of the ordered hit list, over the hits h0 <= h < K
// (hits before h0 are read only as the predecessor of hit h0: a caller that
// splits a long hit list into ranges hands each range its preceding hit, as
// many_step.cu's callers do). Per item:
//   * expansion: the pattern's bit fired in the hit's match words, the hit
//     lies below pos_hi, start = pos + 1 - (depth + b - E) lies in the
//     slice's window [start_lo, start_hi), and the run dedup (a hit whose
//     predecessor is one position earlier and fired the same bit keeps only
//     its b == 0 copy) -- verify_dp.py::expand_candidates;
//   * the DP of banded_dp.cuh on (field, start), the same body
//     banded_dp_kernel runs;
//   * emission: per band the strict-< minimum over the NE edit channels, the
//     span test, and per output slot o of the field's node the f32
//     similarity test ((pl - pen) / pl) * pw >= bound, each step rounded
//     as written (band_minimum and emits of banded_dp.cuh) --
//     verify_dp.py::emit_rows.
// Output: int32 rows (start, penalty f32 bits, span, pattern, packed edit
// counts), ordered channel-major over (band, slot), then by g, which is the
// candidates' combo-major, hit-ascending order: the order emit_rows gives.
// On request each row also gets a tag, channel * n_combo + c: a caller that
// ran a hit list in ranges sorts the rows of all ranges by it (stably) and
// so restores the order one range would have given, which decode's tie rule
// (the earliest row of a span wins a similarity tie) reads.
//
// Ordered output without a sort or a compaction pass: the kernel runs
// twice. The count pass writes, per block, the number of rows of every
// channel (and of live candidates); block_offsets_kernel
// (packed_bitap.cu) turns the channel-major [NCH + 1, nblk] counts into
// offsets; the write pass recomputes the same items and writes each row at
// offsets[channel][block] + its rank inside the block (warp ballots). The
// DP runs twice per live candidate; nothing but the counts and the rows
// touches device memory.
//
// What bounds it on the H100. About 4 % of the grid items are live
// candidates; each is a dependent chain of depth x B x NE cell updates (see
// banded_dp.cu), so the kernel is bound by per-thread instruction latency
// and by how the live items spread over warps, not by bytes: one slice
// reads ~0.5 MB of hits and tables and writes ~0.2 MB of rows.

#include "banded_dp.cuh"

namespace {

using namespace fac_dp;

constexpr int NWARPS = DP_THREADS / 32;
constexpr int MAX_CHANNELS = 128;  // B * MO emission channels a call may have

struct PipeArgs {
  DpCore core;
  const long long* pos;     // [K] ascending hit positions
  const long long* words;   // [K, W2] u32 halves of the match words
  long long K;
  long long h0;             // first hit expanded; hits before it only feed the dedup
  int W2;
  const int32_t* combos;    // [5, n_combo]: word column, bit, field, start offset, b == 0
  int n_combo;
  long long start_lo, start_hi, pos_hi;
  EmitTables emit;
  long long nblk;
  int32_t* counts;          // [NCH + 1, nblk] (count pass)
  const int32_t* offsets;   // exclusive scan of counts (write pass)
  int32_t* rows;            // [total, 5] (write pass)
  int32_t* tags;            // [total] channel * n_combo + combo, or null (write pass)
};

// The DP of one item (alive: field f >= 0, start s; combo c) and its
// emission: the count pass writes the block's rows per channel and its live
// items, the write pass its rows (and their tags, where asked). Every thread
// of the block calls it.
template <int E, bool DEADEND, bool MAPS, typename Sym>
__device__ __forceinline__ void dp_emit(const PipeArgs& a, const float* s_sim, bool sim_smem,
                                        bool write, bool alive, int f, long long s, int c,
                                        int (*s_wc)[NWARPS]) {
  constexpr int B = 2 * E + 1;
  constexpr int NE = E + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int MO = a.emit.MO;
  const int nch = B * MO;

  // DP and the per-band minimum over the edit channels.
  float pen_best[B];
  int cnt_best[B];
  int d = 0, node = 0;
  if (alive) {
    float emit_pen[B][NE];
    int emit_cnt[B][NE];
    dp_body<E, DEADEND, MAPS, Sym>(a.core, s_sim, sim_smem, f, s, emit_pen, emit_cnt);
    band_minimum<E>(emit_pen, emit_cnt, pen_best, cnt_best);
    d = __ldg(a.core.depth + f);
    node = __ldg(a.emit.node + f);
  } else {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      pen_best[b] = __int_as_float(0x7f800000);
      cnt_best[b] = 0;
    }
  }
  const int start = (int)s;

  // Whether channel (b, o) emits for this item, and its pattern.
  auto emits_here = [&](int b, int o, int& pat) -> bool {
    pat = -1;
    return alive && emits(a.emit, a.core.limit, E, start, d, node, b, pen_best[b], o, pat);
  };

  // Rows of every channel per warp (channel nch: live candidates).
#pragma unroll
  for (int b = 0; b < B; ++b) {
    for (int o = 0; o < MO; ++o) {
      int pat;
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, emits_here(b, o, pat));
      if (lane == 0) s_wc[b * MO + o][warp] = __popc(bal);
    }
  }
  {
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, alive);
    if (lane == 0) s_wc[nch][warp] = __popc(bal);
  }
  __syncthreads();

  if (!write) {
    for (int ch = tid; ch <= nch; ch += DP_THREADS) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) total += s_wc[ch][w];
      a.counts[(long long)ch * a.nblk + blockIdx.x] = total;
    }
    return;
  }

#pragma unroll
  for (int b = 0; b < B; ++b) {
    for (int o = 0; o < MO; ++o) {
      int pat;
      const bool ok = emits_here(b, o, pat);
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, ok);
      if (ok) {
        const int ch = b * MO + o;
        long long r = __ldg(a.offsets + (long long)ch * a.nblk + blockIdx.x) +
                      __popc(bal & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) r += s_wc[ch][w];
        int32_t* row = a.rows + r * 5;
        row[0] = start;
        row[1] = __float_as_int(pen_best[b]);
        row[2] = d + (b - E);
        row[3] = pat;
        row[4] = cnt_best[b];
        if (a.tags != nullptr) a.tags[r] = ch * a.n_combo + c;
      }
    }
  }
}

template <int E, bool DEADEND, bool MAPS, typename Sym>
__global__ void __launch_bounds__(DP_THREADS)
dp_pipeline_kernel(PipeArgs a, bool sim_smem, bool write) {
  extern __shared__ float s_sim[];
  __shared__ int s_wc[MAX_CHANNELS + 1][NWARPS];

  load_sim(a.core, s_sim, sim_smem);
  const long long g = (long long)blockIdx.x * DP_THREADS + threadIdx.x;

  // Expansion.
  bool alive = false;
  int f = 0, c = 0;
  long long s = 0;
  const long long KI = a.K - a.h0;
  if (g < KI * a.n_combo) {
    c = (int)(g / KI);
    const long long h = a.h0 + g - (long long)c * KI;
    const int col = __ldg(a.combos + c);
    const int sh = __ldg(a.combos + a.n_combo + c);
    const long long p = __ldg(a.pos + h);
    const bool fired = ((__ldg(a.words + h * a.W2 + col) >> sh) & 1) != 0;
    bool dup = false;
    if (h > 0 && __ldg(a.pos + h - 1) + 1 == p)
      dup = ((__ldg(a.words + (h - 1) * a.W2 + col) >> sh) & 1) != 0;
    s = p + 1 - __ldg(a.combos + 3 * a.n_combo + c);
    alive = fired && p >= 0 && p < a.pos_hi && s >= a.start_lo && s < a.start_hi &&
            (__ldg(a.combos + 4 * a.n_combo + c) != 0 || !dup);
    f = __ldg(a.combos + 2 * a.n_combo + c);
  }

  dp_emit<E, DEADEND, MAPS, Sym>(a, s_sim, sim_smem, write, alive, f, s, c, s_wc);
}

// The instances a route reaches: E = 1, with or without the dead-end filter.
cudaError_t launch_e1(const PipeArgs& a, bool deadend, bool u8, bool write,
                      cudaStream_t stream) {
  constexpr int E = 1;
  const size_t shm = sim_smem_bytes(a.core.C, sizeof(int) * (MAX_CHANNELS + 1) * NWARPS);
  const bool smem = shm != 0;
  const unsigned g = (unsigned)a.nblk;
  if (deadend) {
    if (u8)
      dp_pipeline_kernel<E, true, false, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem, write);
    else
      dp_pipeline_kernel<E, true, false, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem, write);
  } else {
    if (u8)
      dp_pipeline_kernel<E, false, false, uint8_t><<<g, DP_THREADS, shm, stream>>>(a, smem, write);
    else
      dp_pipeline_kernel<E, false, false, int32_t><<<g, DP_THREADS, shm, stream>>>(a, smem, write);
  }
  return cudaGetLastError();
}

// The DP and emission arguments; false where they are out of range.
bool fill_core(PipeArgs& a, const void* ids, long long npad, long long limit,
               const void* path_cls, const void* path_node, const void* depth,
               const void* node, int Lmax, int F, const void* sim, int C,
               const void* node_ceil, const void* sb_edge, const void* out_count, int N,
               const void* out_list, int MO, const void* pat_len, const void* pat_weight,
               float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
               float floor_, float bound, int E, long long nblk, void* counts,
               const void* offsets, void* rows) {
  if (E < 1 || E > MAX_E || Lmax < 1 || F < 1 || C < 1 || N < 1 || MO < 1 ||
      (2 * E + 1) * MO > MAX_CHANNELS || limit < 0 || limit > npad || nblk > 0x7FFFFFFFll) {
    return false;
  }
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
  a.emit.node = static_cast<const int32_t*>(node);
  a.emit.out_list = static_cast<const int32_t*>(out_list);
  a.emit.MO = MO;
  a.emit.pat_len = static_cast<const float*>(pat_len);
  a.emit.pat_weight = static_cast<const float*>(pat_weight);
  a.emit.bound = bound;
  a.nblk = nblk;
  a.counts = static_cast<int32_t*>(counts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.rows = static_cast<int32_t*>(rows);
  return true;
}

}  // namespace

extern "C" {

// Threads per block of the pipeline: the callers size ``counts`` from it
// (nblk = ceil((K - h0) * n_combo / fac_dp_pipeline_threads())).
int fac_dp_pipeline_threads() { return DP_THREADS; }

// pos: int64 [K]; words: int64 [K, W2]; the hits h0..K-1 are expanded;
// combos: int32 [5, n_combo]; the DP tables as fac_banded_dp takes them;
// node: int32 [F]; out_list: int32 [N, MO]; pat_len, pat_weight: f32 [P];
// E = 1 only (the list step of dp_list.cu serves every other count-channel
// call: E >= 2, a forbid mask, mapping arrivals). write == 0:
// counts int32 [(2E+1) MO + 1, nblk] is written; write == 1: offsets (the
// exclusive scan of counts, int32) is read and rows int32 [total, 5]
// written, and where tags is not null the rows' tags int32 [total]. Returns
// the launch's cudaError_t (0 = launched).
int fac_dp_pipeline(const void* pos, const void* words, long long K, long long h0, int W2,
                    const void* combos, int n_combo, long long start_lo,
                    long long start_hi, long long pos_hi,
                    const void* ids, int ids_u8, long long npad, long long limit,
                    const void* path_cls, const void* path_node, const void* depth,
                    const void* node, int Lmax, int F, const void* sim, int C,
                    const void* node_ceil, const void* sb_edge,
                    const void* out_count, int N, const void* out_list, int MO,
                    const void* pat_len, const void* pat_weight,
                    float max_pen, float p_sub, float p_ins, float p_del,
                    float p_swap, float floor_, float bound, int E, int deadend,
                    int write, long long nblk,
                    void* counts, const void* offsets, void* rows, void* tags, void* stream) {
  PipeArgs a{};
  if (K < 1 || h0 < 0 || h0 >= K || W2 < 2 || n_combo < 1 ||
      nblk != ((K - h0) * n_combo + DP_THREADS - 1) / DP_THREADS ||
      E != 1 ||
      !fill_core(a, ids, npad, limit, path_cls, path_node, depth, node, Lmax, F, sim, C,
                 node_ceil, sb_edge, out_count, N, out_list, MO, pat_len, pat_weight, max_pen,
                 p_sub, p_ins, p_del, p_swap, floor_, bound, E, nblk, counts, offsets, rows)) {
    return (int)cudaErrorInvalidValue;
  }
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
  a.tags = static_cast<int32_t*>(tags);
  return (int)launch_e1(a, deadend != 0, ids_u8 != 0, write != 0,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
