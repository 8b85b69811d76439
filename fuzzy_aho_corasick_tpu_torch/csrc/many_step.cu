// The large-dictionary lane's chunk step -- sparse candidate expansion,
// banded Damerau DP and emission in one kernel -- for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device functions of
// fuzzy_aho_corasick_tpu/ops/many.py::_many_pipeline_jit behind the scan:
// _expand_candidates_sparse (:330) with its containment pre-verify, then
// _banded_dp + _emit_rows (:469-482), which XLA compiled from whole-array ops
// with static capacities (compactions of the nonzero (hit, u32 column)
// pairs, of the candidates and of the rows). Its plain torch version is
// ops/many.py::many_step_torch (expand_candidates_sparse -> dp_list_torch);
// the wrapper is many.many_step.
//
// What it computes. Items are (band b, hit h), band-major: g = b * (K - h0)
// + h - h0, over the hits h0 <= h < K (hits before h0 are read only as the
// predecessor of hit h0: a caller that splits a long hit list into ranges
// hands each range its preceding hit, so the dedup below sees across the
// cut). Per item, for each nonzero u32 column c of the hit's match words
// (hits at positions >= 0 and < pos_hi only), in ascending c, and for each
// of that column's R expansion rows r (verify field, bit shift, field depth;
// field -1 pads) in ascending r, the candidate (field, start = pos + 1 -
// (depth + b - E)) is live when:
//   * the row's bit is set in the column's word;
//   * b == 0, or the hit one position earlier did not fire the same bit in
//     that column (the hit-run dedup: its expansion covers these starts);
//   * start_lo <= start < start_hi;
//   * the containment test, where the caller asks for it: a row of depth
//     >= 4 needs at least 4 - k of its field's first 4 path classes
//     somewhere in the corpus window [pos + 1 - depth - 2k, + 4 + 4k),
//     clipped to the pair's window [wlo, wlo + WP), WP = 4 + 4k + rd_max -
//     rd_min, wlo = clip(pos + 1 - rd_max - 2k, 0, max(start_hi - WP, 0));
//     reads past the stream read its last symbol, as the JAX gather clamps
//     them.
// That is the JAX function's candidate order (band, then (hit, column)
// pair, then row). Each live candidate then runs the DP of banded_dp.cuh
// (dp_body, the body every DP kernel of the port runs) and emits, per
// emission channel (DP band, output slot of its field's node), the rows
// band_minimum and emits decide (verify_dp.py::emit_rows). Output: int32
// rows (start, penalty f32 bits, span, pattern, packed edit counts),
// channel-major, then in candidate order: the order _emit_rows gives.
//
// Ordered output without a candidate list or a sort: a warp walks one item.
// Its lanes read the hit's columns side by side, a ballot names the nonzero
// ones, and for each the lanes take one row each; a lane whose row gives a
// live candidate runs its DP, and a ballot per channel ranks the lanes'
// rows. Inside one channel the rows therefore come out by item, then by the
// warp's (column, 32 rows) iteration, then by lane: candidate order. The
// kernel runs twice. The count pass writes per item the rows of each
// channel, its live candidates and (band 0) its nonzero pairs, counts
// [nch + 2, items]; block_offsets_kernel (scan_offsets.cu) scans them
// channel-major; the host reads the three totals in one strided read; the
// write pass skips the items without rows and writes each row at
// offsets[channel][item] plus the channel's rows the warp wrote before it
// (a per-warp running count in shared memory) plus its rank in the ballot.
// Per-item counts, not per-block ones, because the warps of a block run
// different numbers of iterations: no warp waits for another. Each DP runs
// twice (count pass, and the write pass for items with rows); nothing but
// the counts and the rows touches device memory, and the host does not
// wait between the expansion and the DP.
//
// What bounds it on the H100. Per item: 2W column reads, R row reads per
// nonzero column, up to 4 x (4 + 4k) window compares per row, then a DP of
// depth x B x NE cells per live candidate. Hits are ~1e-3 of the corpus and
// most items give zero to two candidates, so it is bound by the latency of
// those dependent reads and of one DP per warp, not by bytes or by
// instruction rate; the warp's other lanes idle through the DP. The tables
// are read through the read-only cache (KiB); the pair's containment window
// (at most WIN_MAX symbols) is read from the dense u8 stream once per item
// into shared memory, where each row's compares read it (reading the
// stream per compare measured slower on the folded many1k chunk); the
// similarity table is in shared memory where it fits.

#include "banded_dp.cuh"

namespace {

using namespace fac_dp;

constexpr int STEP_WARPS = DP_THREADS / 32;  // items per block
constexpr int MAX_CHANNELS = 128;            // B * MO emission channels a call may have
constexpr int CONTAIN_J = 4;                 // path classes of a row the containment test reads
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WIN_MAX = 128;                 // bytes of a pair's containment window

struct StepArgs {
  DpCore core;              // ids: the dense u8 class ids [npad], also the containment's
  long long npad;
  EmitTables emit;
  const long long* pos;     // [K] ascending hit positions
  const long long* words;   // [K, W2] u32 halves of the match words
  long long K;
  long long h0;             // first hit expanded; hits before it only feed the dedup
  int W2;
  const int32_t* field;     // [W2, R] verify field per row, -1 pads
  const int32_t* shift;     // [W2, R]
  const int32_t* rdepth;    // [W2, R] the row's field depth
  const int32_t* pc;        // [W2, R, CONTAIN_J] first path classes, -1 pads
  int R, k, rd_min, rd_max;
  bool contain;             // the containment test
  long long start_lo, start_hi, pos_hi;
  long long items;          // (2E + 1) (K - h0)
  int32_t* counts;          // [nch + 2, items] (count pass; read by the write pass)
  const int32_t* offsets;   // exclusive scan of counts (write pass)
  int32_t* rows;            // [total, 5] (write pass)
};

// Whether row (c, r) passes the containment test for a hit ending at
// ``ends`` (the exclusive end) inside the pair's window [wlo, wlo + wp),
// staged in ``win``.
__device__ __forceinline__ bool contained(const StepArgs& a, int c, int r, int rd,
                                          long long ends, long long wlo, int wp,
                                          const uint8_t* win) {
  const int wj = CONTAIN_J + 4 * a.k;
  const long long lo_r = ends - rd - 2 * a.k;
  const long long t0 = lo_r > wlo ? lo_r : wlo;
  const long long t1 = lo_r + wj < wlo + wp ? lo_r + wj : wlo + wp;
  const int32_t* pc = a.pc + ((long long)c * a.R + r) * CONTAIN_J;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < CONTAIN_J; ++j) {
    const int want = __ldg(pc + j);
    bool found = false;
    for (long long t = t0; t < t1; ++t)
      found |= (int)win[t - wlo] == want;
    cnt += found;
  }
  return cnt >= CONTAIN_J - a.k;
}

// The DP and the emission of the warp's live candidates of one iteration
// (``live`` on the lanes that hold one: field f, start s). The count pass
// adds each channel's rows to the warp's running counts ``run``; the write
// pass writes them at ``run[ch]`` on and moves ``run[ch]`` past them. Every
// lane of the warp calls it.
template <int E, bool DEADEND>
__device__ __forceinline__ void dp_emit_warp(const StepArgs& a, const float* s_sim,
                                             bool sim_smem, bool write, bool live, int f,
                                             long long s, int* run) {
  constexpr int B = 2 * E + 1;
  const int lane = threadIdx.x & 31;
  float pen_best[B];
  int cnt_best[B];
  int d = 0, node = 0;
  if (live) {
    float emit_pen[B][E + 1];
    int emit_cnt[B][E + 1];
    dp_body<E, DEADEND, false, uint8_t>(a.core, s_sim, sim_smem, f, s, emit_pen, emit_cnt);
    band_minimum<E>(emit_pen, emit_cnt, pen_best, cnt_best);
    d = __ldg(a.core.depth + f);
    node = __ldg(a.emit.node + f);
  }
  const int start = (int)s;
  const int MO = a.emit.MO;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    for (int o = 0; o < MO; ++o) {
      int pat = -1;
      const bool ok = live && emits(a.emit, a.core.limit, E, start, d, node, b, pen_best[b], o,
                                    pat);
      const unsigned bal = __ballot_sync(FULL, ok);
      if (bal == 0u) continue;
      const int ch = b * MO + o;
      if (!write) {
        if (lane == 0) run[ch] += __popc(bal);
        continue;
      }
      const int at = run[ch];
      if (ok) {
        int32_t* row = a.rows + ((long long)at + __popc(bal & ((1u << lane) - 1u))) * 5;
        row[0] = start;
        row[1] = __float_as_int(pen_best[b]);
        row[2] = d + (b - E);
        row[3] = pat;
        row[4] = cnt_best[b];
      }
      __syncwarp();  // every lane has read run[ch]
      if (lane == 0) run[ch] = at + __popc(bal);
      __syncwarp();
    }
  }
}

// Block i holds items i * STEP_WARPS .. + STEP_WARPS - 1, a warp each.
template <int E, bool DEADEND>
__global__ void __launch_bounds__(DP_THREADS)
many_step_kernel(StepArgs a, bool sim_smem, bool write) {
  extern __shared__ float s_sim[];
  __shared__ int s_run[STEP_WARPS][MAX_CHANNELS + 2];
  __shared__ uint8_t s_win[STEP_WARPS][WIN_MAX];
  constexpr int B = 2 * E + 1;

  load_sim(a.core, s_sim, sim_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * STEP_WARPS + warp;
  if (g >= a.items) return;
  const int nch = B * a.emit.MO;
  int* run = s_run[warp];
  if (write) {
    // An item without rows has nothing to write; the others start each
    // channel at their offset.
    int mine = 0;
    for (int ch = lane; ch < nch; ch += 32) mine += __ldg(a.counts + ch * a.items + g);
    if (__reduce_add_sync(FULL, (unsigned)mine) == 0u) return;
    for (int ch = lane; ch < nch; ch += 32) run[ch] = __ldg(a.offsets + ch * a.items + g);
  } else {
    for (int ch = lane; ch < nch + 2; ch += 32) run[ch] = 0;
  }
  __syncwarp();

  // Expansion of item g, its candidates' DP and emission as they come.
  const long long KI = a.K - a.h0;
  const int b = (int)(g / KI);
  const long long h = a.h0 + g - (long long)b * KI;
  const long long p = __ldg(a.pos + h);
  if (p >= 0 && p < a.pos_hi) {
    const long long ends = p + 1;
    const bool prev_same = h > 0 && __ldg(a.pos + h - 1) + 1 == p;
    const int wp = CONTAIN_J + 4 * a.k + a.rd_max - a.rd_min;
    long long wlo = ends - a.rd_max - 2 * a.k;
    const long long whi = a.start_hi - wp > 0 ? a.start_hi - wp : 0;
    wlo = wlo < 0 ? 0 : wlo > whi ? whi : wlo;
    uint8_t* win = s_win[warp];
    if (a.contain) {
      // The pair's window, read once (reads past the stream read its last symbol).
      const uint8_t* ids = static_cast<const uint8_t*>(a.core.ids);
      for (int t = lane; t < wp; t += 32)
        win[t] = __ldg(ids + (wlo + t < a.npad ? wlo + t : a.npad - 1));
      __syncwarp();
    }
    const long long* wrow = a.words + h * a.W2;
    for (int c0 = 0; c0 < a.W2; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t w = c < a.W2 ? (uint32_t)__ldg(wrow + c) : 0u;
      const uint32_t wprev = (prev_same && c < a.W2) ? (uint32_t)__ldg(wrow - a.W2 + c) : 0u;
      unsigned nz = __ballot_sync(FULL, w != 0u);
      if (!write && b == 0 && lane == 0) run[nch + 1] += __popc(nz);
      while (nz != 0u) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1u;
        const int cc = c0 + src;
        const uint32_t wc = __shfl_sync(FULL, w, src);
        const uint32_t wpc = __shfl_sync(FULL, wprev, src);
        for (int r0 = 0; r0 < a.R; r0 += 32) {
          const int r = r0 + lane;
          bool live = false;
          int f = -1;
          long long start = 0;
          if (r < a.R) {
            const long long cr = (long long)cc * a.R + r;
            f = __ldg(a.field + cr);
            const int sh = __ldg(a.shift + cr);
            if (f >= 0 && ((wc >> sh) & 1u) && !(b > 0 && ((wpc >> sh) & 1u))) {
              const int rd = __ldg(a.rdepth + cr);
              start = ends - (rd + (b - E));
              live = start >= a.start_lo && start < a.start_hi &&
                     (!a.contain || rd < CONTAIN_J || contained(a, cc, r, rd, ends, wlo, wp, win));
            }
          }
          const unsigned bal = __ballot_sync(FULL, live);
          if (bal == 0u) continue;
          if (!write && lane == 0) run[nch] += __popc(bal);
          dp_emit_warp<E, DEADEND>(a, s_sim, sim_smem, write, live, f, start, run);
        }
      }
    }
  }
  if (!write) {
    __syncwarp();
    for (int ch = lane; ch < nch + 2; ch += 32) a.counts[ch * a.items + g] = run[ch];
  }
}

template <int E>
cudaError_t launch_e(const StepArgs& a, bool deadend, bool write, cudaStream_t stream) {
  const size_t shm =
      sim_smem_bytes(a.core.C, sizeof(int) * STEP_WARPS * (MAX_CHANNELS + 2) + STEP_WARPS * WIN_MAX);
  const unsigned g = (unsigned)((a.items + STEP_WARPS - 1) / STEP_WARPS);
  if (deadend)
    many_step_kernel<E, true><<<g, DP_THREADS, shm, stream>>>(a, shm != 0, write);
  else
    many_step_kernel<E, false><<<g, DP_THREADS, shm, stream>>>(a, shm != 0, write);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: int64 [K]; words: int64 [K, W2]; the hits h0..K-1 are expanded;
// field, shift, rdepth: int32 [W2, R]; pc: int32 [W2, R, 4]; contain: the
// containment test on the dense ids; ids: u8 [npad]; the DP and emission
// tables as fac_dp_pipeline takes them. write == 0: counts int32 [(2E+1) MO
// + 2, (2E+1)(K - h0)] is written (rows per channel, then live candidates,
// then nonzero pairs, per item); write == 1: counts and offsets (their
// exclusive scan) are read and rows int32 [total, 5] written. Returns the
// launch's cudaError_t (0 = launched).
int fac_many_step(const void* pos, const void* words, long long K, long long h0, int W2,
                  const void* field, const void* shift, const void* rdepth, const void* pc,
                  int R, int k, int rd_min, int rd_max, int contain, long long start_lo,
                  long long start_hi, long long pos_hi, const void* ids, long long npad,
                  long long limit, const void* path_cls, const void* path_node,
                  const void* depth, const void* node, int Lmax, int F, const void* sim, int C,
                  const void* node_ceil, const void* sb_edge, const void* out_count, int N,
                  const void* out_list, int MO, const void* pat_len, const void* pat_weight,
                  float max_pen, float p_sub, float p_ins, float p_del, float p_swap,
                  float floor_, float bound, int E, int deadend, int write, void* counts,
                  const void* offsets, void* rows, void* stream) {
  const long long items = (2LL * E + 1) * (K - h0);
  if (K < 1 || h0 < 0 || h0 >= K || W2 < 2 || R < 1 || E < 1 || E > MAX_E || k < 0 || k > 6 ||
      rd_min < 1 || rd_max < rd_min || CONTAIN_J + 4 * k + rd_max - rd_min > WIN_MAX ||
      npad < 1 || limit < 0 || limit > npad || Lmax < 1 ||
      F < 1 || C < 1 || N < 1 || MO < 1 || (2 * E + 1) * MO > MAX_CHANNELS ||
      (items + STEP_WARPS - 1) / STEP_WARPS > 0x7FFFFFFFll ||
      (write != 0 && (offsets == nullptr || rows == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  StepArgs a{};
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
  a.npad = npad;
  a.emit.node = static_cast<const int32_t*>(node);
  a.emit.out_list = static_cast<const int32_t*>(out_list);
  a.emit.MO = MO;
  a.emit.pat_len = static_cast<const float*>(pat_len);
  a.emit.pat_weight = static_cast<const float*>(pat_weight);
  a.emit.bound = bound;
  a.pos = static_cast<const long long*>(pos);
  a.words = static_cast<const long long*>(words);
  a.K = K;
  a.h0 = h0;
  a.W2 = W2;
  a.field = static_cast<const int32_t*>(field);
  a.shift = static_cast<const int32_t*>(shift);
  a.rdepth = static_cast<const int32_t*>(rdepth);
  a.pc = static_cast<const int32_t*>(pc);
  a.R = R;
  a.k = k;
  a.rd_min = rd_min;
  a.rd_max = rd_max;
  a.contain = contain != 0;
  a.start_lo = start_lo;
  a.start_hi = start_hi;
  a.pos_hi = pos_hi;
  a.items = items;
  a.counts = static_cast<int32_t*>(counts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.rows = static_cast<int32_t*>(rows);
  const bool de = deadend != 0, wr = write != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1: return (int)launch_e<1>(a, de, wr, s);
    case 2: return (int)launch_e<2>(a, de, wr, s);
    case 3: return (int)launch_e<3>(a, de, wr, s);
    case 4: return (int)launch_e<4>(a, de, wr, s);
    case 5: return (int)launch_e<5>(a, de, wr, s);
    case 6: return (int)launch_e<6>(a, de, wr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
