// Sparse candidate expansion of the large-dictionary lane, for Hopper
// (sm_90a).
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/many.py::_expand_candidates_sparse, with its
// containment pre-verify, which XLA compiled from whole-array ops with
// static capacities (a compaction of the nonzero (hit, u32 column) pairs,
// then of the candidates). Its plain torch version is
// ops/many.py::expand_candidates_sparse; the wrapper is many.many_expand.
//
// What it computes. Items are (band b, hit h), band-major: g = b * (K - h0)
// + h - h0, over the hits h0 <= h < K (hits before h0 are read only as the
// predecessor of hit h0: a caller that splits a long hit list into ranges
// hands each range its preceding hit, so the dedup below sees across the
// cut). Per item, for each nonzero u32 column c of the hit's match words (hits at
// positions >= 0 and < pos_hi only), in ascending c, and for each of that
// column's R expansion rows r (verify field, bit shift, field depth; field
// -1 pads) in ascending r, the candidate (field, start = pos + 1 - (depth +
// b - E)) is kept when:
//   * the row's bit is set in the column's word;
//   * b == 0, or the hit one position earlier did not fire the same bit in
//     that column (the hit-run dedup: its expansion covers these starts);
//   * start_lo <= start < start_hi;
//   * the containment test, where the caller gives the dense id stream (it
//     does when some row's depth is >= 4): a row of depth >= 4 needs at
//     least 4 - k of its field's first 4 path classes somewhere in the
//     corpus window [pos + 1 - depth - 2k, + 4 + 4k), clipped to the pair's
//     window [wlo, wlo + WP), WP = 4 + 4k + rd_max - rd_min, wlo = clip(pos +
//     1 - rd_max - 2k, 0, max(start_hi - WP, 0)); reads past the stream read
//     its last symbol, as the JAX gather clamps them.
// That is the order of the JAX function's compaction (band, then (hit,
// column) pair, then row), so the candidates come out equal element by
// element. The items with b == 0 also count the nonzero pairs.
//
// Ordered output without a sort: the kernel runs twice. The count pass
// writes, per block, the number of candidates and of pairs ([2, nblk]);
// block_offsets_kernel (packed_bitap.cu) scans them; the write pass counts
// its items again, then writes each candidate at its block's offset plus the
// candidates of the items before it in the block and of the rows before it
// in its item (warp ballots).
//
// What bounds it on the H100. Per item the work is 2W column reads of the
// hit's words and, per nonzero column, R row reads and up to 4 x (4 + 4k)
// window compares per row; hits are ~1e-3 of the corpus and almost every
// hit has one nonzero column, so it is bound by the latency of those
// dependent reads, not by bytes or by instruction rate. Its design: a warp
// per item. The lanes read the hit's columns side by side (coalesced), a
// ballot names the nonzero ones, and for each the lanes take one row each,
// so an item costs a few dependent reads, not 2W + R of them in a row. (One
// thread per item measured 0.35 ms per pass over 16.6 K items on an H100:
// its lanes reach their nonzero columns at different iterations, so a warp
// ran the rows of its 32 items one after another.) The tables are read
// through the read-only cache (they are KiB), the window straight from the
// dense u8 stream per row (the TPU gathered one window per pair because its
// per-row gathers were slow).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EXPAND_THREADS = 256;
constexpr int EXPAND_WARPS = EXPAND_THREADS / 32;  // items per block
constexpr int CONTAIN_J = 4;  // path classes of a row the containment test reads

struct ExpandArgs {
  const long long* pos;     // [K] ascending hit positions
  const long long* words;   // [K, W2] u32 halves of the match words
  long long K;
  long long h0;             // first hit expanded; hits before it only feed the dedup
  int W2;
  const int32_t* field;     // [W2, R] verify field per row, -1 pads
  const int32_t* shift;     // [W2, R]
  const int32_t* depth;     // [W2, R]
  const int32_t* pc;        // [W2, R, CONTAIN_J] first path classes, -1 pads
  int R, E, k, rd_min, rd_max;
  long long start_lo, start_hi, pos_hi;
  const uint8_t* ids;       // dense class ids [npad]; null: no containment test
  long long npad;
  long long nblk;
  int32_t* counts;          // [2, nblk] candidates, pairs (count pass)
  const int32_t* offsets;   // exclusive scan of counts (write pass)
  int32_t* cand_field;      // [candidates] (write pass)
  int32_t* cand_start;
};

// Whether row (c, r) passes the containment test for a hit ending at
// ``ends`` (the exclusive end) inside the pair's window [wlo, wlo + wp).
__device__ __forceinline__ bool contained(const ExpandArgs& a, int c, int r, int rd,
                                          long long ends, long long wlo, int wp) {
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
      found |= (int)__ldg(a.ids + (t < a.npad ? t : a.npad - 1)) == want;
    cnt += found;
  }
  return cnt >= CONTAIN_J - a.k;
}

// Item g, walked by one warp: returns its candidates (and adds its nonzero
// pairs to ``pairs`` at b == 0). With WRITE, candidate j of the item goes
// to cand_*[at + j]. Every lane of the warp calls it; all branches around
// the ballots and shuffles are uniform over the warp.
template <bool WRITE>
__device__ __forceinline__ int expand_item(const ExpandArgs& a, long long g, long long at,
                                           int& pairs) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long KI = a.K - a.h0;
  const int b = (int)(g / KI);
  const long long h = a.h0 + g - (long long)b * KI;
  const long long p = __ldg(a.pos + h);
  if (p < 0 || p >= a.pos_hi) return 0;
  const long long ends = p + 1;
  const bool prev_same = h > 0 && __ldg(a.pos + h - 1) + 1 == p;
  const bool contain = a.ids != nullptr;
  const int wp = CONTAIN_J + 4 * a.k + a.rd_max - a.rd_min;
  long long wlo = ends - a.rd_max - 2 * a.k;
  const long long whi = a.start_hi - wp > 0 ? a.start_hi - wp : 0;
  wlo = wlo < 0 ? 0 : wlo > whi ? whi : wlo;
  const long long* row = a.words + h * a.W2;
  int count = 0;
  for (int c0 = 0; c0 < a.W2; c0 += 32) {
    const int c = c0 + lane;
    const uint32_t w = c < a.W2 ? (uint32_t)__ldg(row + c) : 0u;
    const uint32_t wprev = (prev_same && c < a.W2) ? (uint32_t)__ldg(row - a.W2 + c) : 0u;
    unsigned nz = __ballot_sync(0xFFFFFFFFu, w != 0u);
    if (b == 0) pairs += __popc(nz);
    while (nz != 0u) {
      const int src = __ffs(nz) - 1;
      nz &= nz - 1u;
      const int cc = c0 + src;
      const uint32_t wc = __shfl_sync(0xFFFFFFFFu, w, src);
      const uint32_t wpc = __shfl_sync(0xFFFFFFFFu, wprev, src);
      for (int r0 = 0; r0 < a.R; r0 += 32) {
        const int r = r0 + lane;
        bool ok = false;
        int f = -1;
        long long start = 0;
        if (r < a.R) {
          const long long cr = (long long)cc * a.R + r;
          f = __ldg(a.field + cr);
          const int sh = __ldg(a.shift + cr);
          if (f >= 0 && ((wc >> sh) & 1u) && !(b > 0 && ((wpc >> sh) & 1u))) {
            const int rd = __ldg(a.depth + cr);
            start = ends - (rd + (b - a.E));
            ok = start >= a.start_lo && start < a.start_hi &&
                 (!contain || rd < CONTAIN_J || contained(a, cc, r, rd, ends, wlo, wp));
          }
        }
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, ok);
        if (WRITE && ok) {
          const long long o = at + count + __popc(bal & lt);
          a.cand_field[o] = f;
          a.cand_start[o] = (int32_t)start;
        }
        count += __popc(bal);
      }
    }
  }
  return count;
}

// Block i holds items i * EXPAND_WARPS .. + EXPAND_WARPS - 1, a warp each.
__global__ void __launch_bounds__(EXPAND_THREADS)
many_expand_kernel(ExpandArgs a, bool write) {
  __shared__ int s_warp[2][EXPAND_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * EXPAND_WARPS + warp;
  const bool live = g < (2LL * a.E + 1) * (a.K - a.h0);
  int pairs = 0;
  const int cands = live ? expand_item<false>(a, g, 0, pairs) : 0;
  if (lane == 0) {
    s_warp[0][warp] = cands;
    s_warp[1][warp] = pairs;
  }
  __syncthreads();
  if (!write) {
    if (threadIdx.x < 2) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < EXPAND_WARPS; ++w) total += s_warp[threadIdx.x][w];
      a.counts[(long long)threadIdx.x * a.nblk + blockIdx.x] = total;
    }
    return;
  }
  if (cands == 0) return;
  long long at = __ldg(a.offsets + blockIdx.x);
  for (int w = 0; w < warp; ++w) at += s_warp[0][w];
  expand_item<true>(a, g, at, pairs);
}

}  // namespace

extern "C" {

// Items per block of many_expand_kernel: the callers size ``counts`` from it
// (nblk = ceil((2E + 1) * (K - h0) / fac_many_expand_items())).
int fac_many_expand_items() { return EXPAND_WARPS; }

// pos: int64 [K]; words: int64 [K, W2]; the hits h0..K-1 are expanded; field, shift, depth: int32 [W2, R];
// pc: int32 [W2, R, 4]; ids: u8 [npad] or null (no containment test).
// write == 0: counts int32 [2, nblk] is written; write == 1: offsets (the
// exclusive scan of counts) is read and cand_field, cand_start int32
// [candidates] written. Returns the launch's cudaError_t (0 = launched).
int fac_many_expand(const void* pos, const void* words, long long K, long long h0, int W2,
                    const void* field, const void* shift, const void* depth, const void* pc,
                    int R, int E, long long start_lo, long long start_hi, long long pos_hi,
                    const void* ids, long long npad, int k, int rd_min, int rd_max, int write,
                    long long nblk, void* counts, const void* offsets, void* cand_field,
                    void* cand_start, void* stream) {
  if (K < 1 || h0 < 0 || h0 >= K || W2 < 2 || R < 1 || E < 1 || E > 6 || k < 0 || k > 6 || rd_min < 1 ||
      rd_max < rd_min || (ids != nullptr && npad < 1) ||
      nblk != ((2LL * E + 1) * (K - h0) + EXPAND_WARPS - 1) / EXPAND_WARPS ||
      nblk > 0x7FFFFFFFll) {
    return (int)cudaErrorInvalidValue;
  }
  ExpandArgs a;
  a.pos = static_cast<const long long*>(pos);
  a.words = static_cast<const long long*>(words);
  a.K = K;
  a.h0 = h0;
  a.W2 = W2;
  a.field = static_cast<const int32_t*>(field);
  a.shift = static_cast<const int32_t*>(shift);
  a.depth = static_cast<const int32_t*>(depth);
  a.pc = static_cast<const int32_t*>(pc);
  a.R = R;
  a.E = E;
  a.k = k;
  a.rd_min = rd_min;
  a.rd_max = rd_max;
  a.start_lo = start_lo;
  a.start_hi = start_hi;
  a.pos_hi = pos_hi;
  a.ids = static_cast<const uint8_t*>(ids);
  a.npad = npad;
  a.nblk = nblk;
  a.counts = static_cast<int32_t*>(counts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.cand_field = static_cast<int32_t*>(cand_field);
  a.cand_start = static_cast<int32_t*>(cand_start);
  many_expand_kernel<<<(unsigned)nblk, EXPAND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, write != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
