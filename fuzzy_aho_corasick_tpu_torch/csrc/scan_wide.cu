// Packed multi-pattern shift-AND (Wu-Manber) NFA for Hopper (sm_90a): the
// ordered hit-list scan at W = 9..64 u64 limbs with k = 0..6 error rows, and
// at W = 1..64 with k = 7..24.
//
// Replaces the traced-table form of the JAX package's one Pallas kernel body
// (fuzzy_aho_corasick_tpu/ops/packed_bitap.py::_kernel_factory with
// consts=None: tables in SMEM, the Damerau recurrence switched on by a traced
// ``notlast``) in its two call shapes, at the widths the large-dictionary
// lane (fuzzy_aho_corasick_tpu/ops/many.py) and the wide exact dictionaries
// scan with, and at the budgets past the one-thread chains' six rows that
// the mapped lane (2E-4E rows at E = 2..6), the beam anchors and the Damerau
// budgets of a high edit count scan with (up to MAX_USEFUL_K = 24 rows):
//
//   scan_bits_wide_kernel <- _pallas_scan  : one hit BIT per stream position
//                                            and the hits of every block;
//   hit_words_wide_kernel <- _replay_words : ascending hit positions and,
//                                            for each, the 2W u32 match words.
//
// Their outputs are exactly those of scan_bits_kernel and hit_words_kernel
// (packed_bitap.cu): the same bit words, the same per-block counts, which
// block_offsets_kernel scans unchanged, the same ascending positions and
// [count, 2W] words. So scan_bits_torch and hit_words_torch
// (ops/packed_bitap.py) are their plain versions, and the recurrence and
// every semantic point of packed_bitap.cu hold here as written there.
//
// What bounds the scan on the H100: the integer instruction rate, never the
// 1 byte per symbol it reads. No field straddles a limb and ``notlast`` is
// per limb, so limbs are independent: a chain is a group of G lanes of one
// warp, each stepping the same symbols (the same 16-byte loads, one
// transaction for the group) on its own LPL limbs, with the state in
// registers. Once per 32 symbols the group ORs its hit words with shuffles
// and its first lane writes the bit word. Every chain runs the same number
// of steps (chains past the stream read symbol 0 and write zero words), so
// the shuffles never meet a diverged warp. One chain scans WIDE_CHUNK
// symbols after its ``halo`` warm-up.
//
// k >= 1 (scan_chains). At W = 31 with k = 1 under the Damerau rows a chain
// carries 31 x 3 u64 words of state, 186 registers, and ~870 instructions
// per symbol, which hide the table reads. (LPL, G) = (2, 8) for W = 9..16,
// (4, 8) for 17..32 and (4, 16) for 33..64, for k = 1, 2 and the
// run-time-masked k = 3..6, with and without the Damerau rows; the [A, W]
// word table, padded to G x LPL limbs with zero columns and to MAX_A rows,
// sits in dynamic shared memory (18-73 KiB).
//
// k = 7..24 (scan_chains again, the deep instances). A one-thread chain
// cannot carry these rows: at W = 8 and K = 24 under Damerau that is 49 x 8
// u64 of state. Here a lane carries ONE limb (LPL = 1, G = the power of two
// >= W, 1..32 lanes) up to W = 32, and two past it (LPL = 2, G = 32): at
// most 49 and 98 u64 of state. Two masked row templates, K = 12 (k =
// 7..12) and K = 24 (k = 13..24), with and without the Damerau rows; the
// rows past k are skipped, not computed. Past 8 lanes a block holds 256 /
// G chains (256 threads, so that ptxas may give a lane up to 255
// registers), each scanning BLOCK_SYMS / chains symbols (1,024 or 2,048);
// up to 8 lanes 32 chains of WIDE_CHUNK. The table, padded to G x LPL
// limbs, and K + 1 match and init rows sit in dynamic shared memory
// (1.4-91 KiB). The chain's step is a serial chain over the rows (row d
// reads row d - 1's new word), about 4 dependent operations a row: a
// simple design that is right, not a fast one (PERF.md has its times).
//
// k = 0 (scan_chains_k0). One u64 of state per limb and 6 instructions per
// limb and symbol, so the per-symbol work a lane repeats whatever its limb
// count (the byte, the row address, the hit test) and the table reads are
// no longer hidden. A chain is G0 = 8 lanes of LPL = ceil(W / 8) limbs
// (2..8: at most 7 limbs computed past W, where a 16-lane chain of 4 limbs
// computed up to 31), so the per-symbol work is paid by 8 lanes. Only the A
// live rows of the table are staged, plus a zero row that every symbol >= A
// reads (the dead symbol); a lane's limbs sit side by side in 16-byte pairs
// (an odd LPL's last pair half empty), read with one 16-byte load each, the
// pairs rotated by lane where a slot holds an even number of them, so the
// 8 lanes of a chain loading one row meet 8 distinct bank groups. Row 0's
// match words stay in registers. At A = 27 and W = 43 that is 11 KiB, under
// the 48 KiB a launch gets without opting in.
//
// hit_words_wide_kernel writes a block's positions as hit_words_kernel does,
// then replays its hits a limb per thread: item i of the block is (hit i / W,
// limb i % W), so a block with three hits of 43 limbs keeps 129 threads busy,
// where groups of 8-16 lanes kept three groups busy. Its time is a chain of
// dependent loads per block (offsets and bit words, positions, symbols,
// table words) times the waves of blocks, so the design shortens both: a
// block is 128 threads (8 fit an SM at k <= 1), loads its bit words beside
// its offsets, keeps its first positions in shared memory, and stages
// nothing: the table words a replay needs come through the read-only cache
// (a replay reads halo rows of W words, the [A, W] table is a few KiB), each
// thread issuing a batch of REPLAY_BATCH symbol loads, then their table
// loads, then their steps. The batch is 12, so that the halos of the
// exact-wide and many1k dictionaries (11 and 12) take one batch, in 64
// registers without spills (16 spilled, 8 took two batches: both measured
// slower). One instance per k (0, 1, 2 and the masked 3..6) with and
// without the Damerau rows.
//
// The deep replay, k = 7..24 (row templates K = 8, 12, 16, 20 and 24, the
// multiple of 4 >= k, with and without the Damerau rows; a thread per limb,
// so one design at every W: one limb a lane, or two past W = 32, is the
// scan's geometry, not the replay's). It replaces the form above at those
// k, which read the K + 1 match and init rows from
// device memory at every symbol (ptxas kept the loads: each unrolled step's
// word may be the last) and ran in the scan's geometry: a block per 16,384
// symbols, so at mapped4's shape (7,833 hits in 1,152 blocks, W = 6, k = 8)
// a block held about 42 items for its 128 threads, 150 registers allowed 3
// blocks an SM, and the hits' clusters set the waves. What bounds the
// function is the integer work of the replays, halo x (k + 1) row steps
// of about 6 operations per (hit, limb); what bounded the kernel was the
// latency of that serial chain, run by few threads at once. So the deep
// replay is two launches. hit_words_wide_kernel_positions writes every
// block's positions, as the block above does. hit_words_wide_kernel<K, D>
// then gives a thread to each (hit, limb) of the whole hit list, a grid of
// resident blocks striding over it, so the clusters spread over the card:
// one wave at mapped4. A thread steps all K + 1 rows of its template
// (K = replay_rows(k), at most 3 rows past k) without a branch per row
// (the rows past k start at zero and no row at or below k reads them),
// the full batches of its halo without a test per symbol, each batch's
// loads issued before the previous batch's steps, and reads its match rows
// once, after the replay.
//
// An instance that needs more than 48 KiB of dynamic shared memory (the
// k >= 1 scan, the k = 0 scan at large A x W) is allowed its largest need
// once per device, not at every launch.

#include <atomic>

#include "packed_bitap.cuh"

namespace {

using namespace fac_scan;

constexpr int WIDE_CHUNK = 512;                           // symbols per chain
constexpr int WIDE_CHAINS = BLOCK_SYMS / WIDE_CHUNK;      // chains per block
constexpr int WIDE_MAX_W = 64;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int G0 = 8;                                     // lanes per k = 0 chain
constexpr int REPLAY_BATCH = 12;                          // symbols a replay loads at once
constexpr int DEEP_BATCH = 8;                             // the same, double-buffered, past k = 6
constexpr int WIDE_HITS_THREADS = 128;                    // threads of a hit-word block
constexpr int HIT_CACHE = 512;                            // positions a block keeps in smem
constexpr int DEEP_THREADS = 256;                         // threads of a deep block past 8 lanes

// Chains per block of a k >= 1 instance with G lanes a chain and K rows.
__host__ __device__ constexpr int chains_of(int G, int K) {
  return K > MAX_K && G > 8 ? DEEP_THREADS / G : WIDE_CHAINS;
}

// Dynamic shared memory of a k >= 1 instance: the [MAX_A, WP] word table and
// the [K + 1, WP] match and init rows.
constexpr size_t wide_smem(int WP, int K) {
  return (size_t)(MAX_A + 2 * (K + 1)) * WP * sizeof(uint64_t);
}

// The tables, padded to WP limbs with zero columns (a padded limb never
// holds a state bit) and to MAX_A symbols with zero rows; rows past the
// call's k read as zero.
template <int WP, int K>
__device__ __forceinline__ void load_wide_tables(const Tables& tb, int A, int W, int k,
                                                 uint64_t* s_tbl, uint64_t* s_match,
                                                 uint64_t* s_init, int tid, int nthreads) {
  for (int i = tid; i < MAX_A * WP; i += nthreads) {
    const int a = i / WP, w = i - a * WP;
    s_tbl[i] = (a < A && w < W) ? tb.tbl[a * W + w] : 0ull;
  }
  for (int i = tid; i < (K + 1) * WP; i += nthreads) {
    const int d = i / WP, w = i - d * WP;
    const bool live = d <= k && w < W;
    s_match[i] = live ? tb.match[d * W + w] : 0ull;
    s_init[i] = live ? tb.init[d * W + w] : 0ull;
  }
}

// The starts and notlast words of limbs l0 .. l0 + LPL - 1.
template <int LPL>
__device__ __forceinline__ void lane_masks(const Tables& tb, int W, int l0, uint64_t* st,
                                           uint64_t* nl) {
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    const int w = l0 + j;
    st[j] = w < W ? tb.starts[w] : 0ull;
    nl[j] = (w < W && tb.notlast != nullptr) ? tb.notlast[w] : ~0ull;
  }
}

// Lane ``lane``'s ``word`` ORed over its group of G lanes; the group's first
// lane writes it as the bit word of positions [p, p + 32) and counts its hits.
template <int G>
__device__ __forceinline__ void put_word(uint32_t word, int lane, long long p, long long n,
                                         uint32_t* __restrict__ bits, int& hits) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) word |= __shfl_xor_sync(0xFFFFFFFFu, word, o);
  if (lane == 0) {
    const uint32_t out = clip_word(word, p, n);
    bits[p / 32] = out;
    hits += __popc(out);
  }
}

// The block's hit count, summed over its threads' ``hits``, to
// block_counts[blockIdx.x].
__device__ __forceinline__ void put_count(int hits, int* s_count, int* __restrict__ block_counts) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xFFFFFFFFu, hits, o);
  if ((threadIdx.x & 31) == 0 && hits != 0) atomicAdd(s_count, hits);
  __syncthreads();
  if (threadIdx.x == 0) block_counts[blockIdx.x] = *s_count;
}

// k >= 1: a block of chains_of(G, K) chains of G lanes covers BLOCK_SYMS
// symbols.
template <int LPL, int G, int K, bool DAM>
__device__ __forceinline__ void scan_chains(const uint8_t* __restrict__ ids, long long n,
                                            const Tables& tb, int A, int W, int k, int halo,
                                            uint32_t* __restrict__ bits,
                                            int* __restrict__ block_counts) {
  constexpr int WP = LPL * G;
  constexpr int CHAINS = chains_of(G, K);
  constexpr int CHUNK = BLOCK_SYMS / CHAINS;
  constexpr int THREADS = CHAINS * G;
  extern __shared__ uint64_t s_wide[];
  uint64_t* s_tbl = s_wide;
  uint64_t* s_match = s_tbl + MAX_A * WP;
  uint64_t* s_init = s_match + (K + 1) * WP;
  __shared__ int s_count;

  const int tid = threadIdx.x, lane = tid % G, chain = tid / G, l0 = lane * LPL;
  load_wide_tables<WP, K>(tb, A, W, k, s_tbl, s_match, s_init, tid, THREADS);
  uint64_t st[LPL], nl[LPL];
  lane_masks<LPL>(tb, W, l0, st, nl);
  if (tid == 0) s_count = 0;
  __syncthreads();

  // This chain reports positions [c0, c0 + CHUNK), warmed up from the
  // fresh state over [c0 - halo, c0); this lane holds limbs l0 .. l0+LPL-1.
  const long long c0 = ((long long)blockIdx.x * CHAINS + chain) * CHUNK;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  const uint64_t* m0 = s_match + l0;
  Nfa<LPL, K, DAM> nfa;
  nfa.reset(s_init + l0, k, WP);
  for (int q = -halo; q < 0; ++q)
    nfa.step_any_row(s_tbl + (sym_at(ids, n, c0 + q) & (MAX_A - 1)) * WP + l0, st, nl, m0, k,
                     WP);
  uint4 cur = load16(ids, n, c0, aligned), nxt = cur;
  uint32_t word = 0u;
  int hits = 0;
  constexpr int rounds = CHUNK / 16;
#pragma unroll 1
  for (int h = 0; h < rounds; ++h) {
    if (h + 1 < rounds) nxt = load16(ids, n, c0 + (h + 1) * 16, aligned);
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const uint32_t four = pick(cur, j);
      uint32_t nib = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sym = (four >> (8 * i)) & 0xFF;
        const bool hit = nfa.step_any_row(s_tbl + (sym & (MAX_A - 1)) * WP + l0, st, nl, m0,
                                          k, WP);
        nib |= (hit ? 1u : 0u) << i;
      }
      word |= nib << ((h & 1) * 16 + j * 4);
    }
    cur = nxt;
    if (h & 1) {
      put_word<G>(word, lane, c0 + (h / 2) * 32, n, bits, hits);
      word = 0u;
    }
  }
  put_count(hits, &s_count, block_counts);
}

// The k = 0 table rows as staged: lane l's LPL limbs in a slot of SL u64
// (16-byte pairs), the G0 slots of a row side by side.
template <int LPL>
struct K0Row {
  static constexpr int SL = (LPL + 1) / 2 * 2;  // u64 per slot
  static constexpr int P = SL / 2;               // 16-byte pairs per slot
  static constexpr int RS = G0 * SL;             // u64 per row

  // Offset in a row of pair q of lane l's slot. Where P is even the pairs
  // are rotated by lane: the 8 lanes loading pair q of one row then meet 8
  // distinct 16-byte bank groups (at odd P the slots' stride spreads them).
  __device__ static int pair_at(int lane, int q) {
    const int rot = P % 2 == 0 ? (lane * P / 8) % P : 0;
    return lane * SL + 2 * ((q + rot) % P);
  }

  static constexpr size_t smem(int A) { return (size_t)(A + 1) * RS * sizeof(uint64_t); }
};

// k = 0: a block of WIDE_CHAINS chains of G0 lanes covers BLOCK_SYMS symbols.
template <int LPL>
__device__ __forceinline__ void scan_chains_k0(const uint8_t* __restrict__ ids, long long n,
                                               const Tables& tb, int A, int W, int halo,
                                               uint32_t* __restrict__ bits,
                                               int* __restrict__ block_counts) {
  using R = K0Row<LPL>;
  constexpr int THREADS = WIDE_CHAINS * G0;
  extern __shared__ __align__(16) uint64_t s_rows[];  // [A + 1, RS]; row A is zero
  __shared__ int s_count;

  const int tid = threadIdx.x, lane = tid % G0, chain = tid / G0;
  for (int i = tid; i < (A + 1) * G0 * LPL; i += THREADS) {
    const int a = i / (G0 * LPL), w = i - a * (G0 * LPL), l = w / LPL, j = w - l * LPL;
    s_rows[a * R::RS + R::pair_at(l, j / 2) + (j & 1)] =
        (a < A && w < W) ? __ldg(tb.tbl + (size_t)a * W + w) : 0ull;
  }
  // This lane's limbs l0 + j: state, starts and row 0's match words, all in
  // registers; past W they are zero (a padded limb never holds a bit).
  const int l0 = lane * LPL;
  uint64_t d[LPL], st[LPL], m[LPL];
  int at[R::P];
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    const bool live = l0 + j < W;
    d[j] = live ? __ldg(tb.init + l0 + j) : 0ull;
    st[j] = live ? __ldg(tb.starts + l0 + j) : 0ull;
    m[j] = live ? __ldg(tb.match + l0 + j) : 0ull;
  }
#pragma unroll
  for (int q = 0; q < R::P; ++q) at[q] = R::pair_at(lane, q);
  if (tid == 0) s_count = 0;
  __syncthreads();

  // One symbol: new = ((d << 1) | starts) & row[sym]; whether some field's
  // last bit is set.
  auto step = [&](int sym) {
    const uint64_t* row = s_rows + min(sym, A) * R::RS;
    uint32_t acc = 0u;
#pragma unroll
    for (int q = 0; q < R::P; ++q) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(row + at[q]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * q + h;
        if (j < LPL) {
          const uint64_t x = ((d[j] << 1) | st[j]) & (h ? v.y : v.x);
          d[j] = x;
          const uint64_t y = x & m[j];
          acc |= (uint32_t)y | (uint32_t)(y >> 32);
        }
      }
    }
    return acc != 0u;
  };

  const long long c0 = ((long long)blockIdx.x * WIDE_CHAINS + chain) * WIDE_CHUNK;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  for (int q = -halo; q < 0; ++q) step(sym_at(ids, n, c0 + q));
  uint4 cur = load16(ids, n, c0, aligned), nxt = cur;
  uint32_t word = 0u;
  int hits = 0;
  constexpr int rounds = WIDE_CHUNK / 16;
#pragma unroll 1
  for (int h = 0; h < rounds; ++h) {
    if (h + 1 < rounds) nxt = load16(ids, n, c0 + (h + 1) * 16, aligned);
    uint32_t half = 0u;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t four = s < 4 ? cur.x : s < 8 ? cur.y : s < 12 ? cur.z : cur.w;
      if (step((four >> (8 * (s & 3))) & 0xFF)) half |= 1u << s;
    }
    word |= half << ((h & 1) * 16);
    cur = nxt;
    if (h & 1) {
      put_word<G0>(word, lane, c0 + (h / 2) * 32, n, bits, hits);
      word = 0u;
    }
  }
  put_count(hits, &s_count, block_counts);
}

template <int LPL, int G, int K, bool DAM>
__global__ void __launch_bounds__(chains_of(G, K) * G)
scan_bits_wide_kernel(const uint8_t* __restrict__ ids, long long n, Tables tb, int A, int W,
                      int k, int halo, uint32_t* __restrict__ bits,
                      int* __restrict__ block_counts) {
  if constexpr (K == 0)
    scan_chains_k0<LPL>(ids, n, tb, A, W, halo, bits, block_counts);
  else
    scan_chains<LPL, G, K, DAM>(ids, n, tb, A, W, k, halo, bits, block_counts);
}

// The match word of limb w at hit position p (k <= 6): the NFA replayed
// over ids[p - halo + 1 .. p] from the fresh state (reads outside the stream
// are the dead symbol 0, symbols >= A a zero row), each thread issuing
// REPLAY_BATCH symbol loads, then their table loads, then their steps. The
// limb's init and match rows are ``in`` and ``mt``, in registers.
template <int K, bool DAM>
__device__ __forceinline__ uint64_t replay_limb(const uint8_t* __restrict__ ids, long long n,
                                                const Tables& tb, int A, int W, int w, int k,
                                                int halo, long long p, uint64_t st,
                                                uint64_t nl, const uint64_t* in,
                                                const uint64_t* mt) {
  Nfa<1, K, DAM> nfa;
  nfa.reset(in, k);
  uint64_t out = 0ull;
  const long long q0 = p - halo + 1;
  for (int j0 = 0; j0 < halo; j0 += REPLAY_BATCH) {
    uint64_t bc[REPLAY_BATCH];
#pragma unroll
    for (int t = 0; t < REPLAY_BATCH; ++t) {
      const int sym = j0 + t < halo ? sym_at(ids, n, q0 + j0 + t) : 0;
      bc[t] = sym < A ? __ldg(tb.tbl + (size_t)sym * W + w) : 0ull;
    }
#pragma unroll
    for (int t = 0; t < REPLAY_BATCH; ++t)
      if (j0 + t < halo) nfa.step_row(bc + t, &st, &nl, mt, k, &out);
  }
  return out;
}

// The positions step of the deep replay (k = 7..24), its first launch:
// block b writes the positions of its set bits to pos[offsets[b] ..) in
// ascending order.
__global__ void __launch_bounds__(WIDE_HITS_THREADS)
hit_words_wide_kernel_positions(const uint32_t* __restrict__ bits,
                                const int* __restrict__ offsets, long long* pos) {
  __shared__ int s_warp[WIDE_HITS_THREADS / 32];
  BlockWords<WIDE_HITS_THREADS> mine;
  mine.load(bits);  // in flight beside the offsets
  const int base = offsets[blockIdx.x], next = offsets[blockIdx.x + 1];
  if (next == base) return;  // no hit in this block
  mine.positions(base, pos, s_warp);
}

// The deep replay's second launch: a thread per (hit i / W, limb i % W)
// over the whole hit list (offsets[nblocks] hits, read on the card), the
// threads of a grid of resident blocks striding over it. Each replays the
// limb's rows over the halo symbols ending at its hit, in registers, from
// the init words. All K + 1 rows (and K Damerau rows) are stepped, not the
// call's k + 1: the rows past k start at zero and no row at or below k reads
// them, and stepping them costs less than a branch per row and step. Only
// the last symbol's match words count, so they are read once, after the
// replay, for the rows up to k. The symbols come in batches of DEEP_BATCH,
// the next batch's loads in flight while a batch is stepped; the batches
// that the halo fills are stepped without a test per symbol.
template <int K, bool DAM>
__device__ __forceinline__ void replay_deep(const uint8_t* __restrict__ ids, long long n,
                                            const Tables& tb, int A, int W, int k, int halo,
                                            long long hits, const long long* __restrict__ pos,
                                            long long* __restrict__ words) {
  const long long items = hits * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < items; i += stride) {
    const long long h = i / W;
    const int w = (int)(i - h * W);
    const long long q0 = __ldg(pos + h) - halo + 1;
    uint64_t st = __ldg(tb.starts + w), nl = ~0ull;
    if constexpr (DAM) nl = __ldg(tb.notlast + w);
    Nfa<1, K, DAM> nfa;
    nfa.reset(tb.init + w, k, W);
    // The table words of symbols j0 .. j0 + DEEP_BATCH - 1 of the window
    // (zero past the halo): each batch's loads are issued before the
    // previous batch's steps.
    auto load = [&](int j0, uint64_t* bc) {
#pragma unroll
      for (int t = 0; t < DEEP_BATCH; ++t) {
        const int sym = j0 + t < halo ? sym_at(ids, n, q0 + j0 + t) : 0;
        bc[t] = sym < A ? __ldg(tb.tbl + (size_t)sym * W + w) : 0ull;
      }
    };
    uint64_t bc[DEEP_BATCH], next[DEEP_BATCH];
    load(0, bc);
    for (int j0 = 0;; j0 += DEEP_BATCH) {
      const bool more = j0 + DEEP_BATCH < halo;
      if (more) load(j0 + DEEP_BATCH, next);
      if (j0 + DEEP_BATCH <= halo) {  // a full batch: no test per symbol
#pragma unroll
        for (int t = 0; t < DEEP_BATCH; ++t)
          nfa.template step_row<false>(bc + t, &st, &nl, nullptr, K, nullptr);
      } else {
#pragma unroll
        for (int t = 0; t < DEEP_BATCH; ++t)
          if (j0 + t < halo) nfa.template step_row<false>(bc + t, &st, &nl, nullptr, K, nullptr);
      }
      if (!more) break;
#pragma unroll
      for (int t = 0; t < DEEP_BATCH; ++t) bc[t] = next[t];
    }
    uint64_t out = 0ull;
#pragma unroll
    for (int d = 0; d <= K; ++d)
      if (d <= k) out |= nfa.r[d][0] & __ldg(tb.match + d * W + w);
    *reinterpret_cast<longlong2*>(words + i * 2) =
        make_longlong2((long long)(out & 0xFFFFFFFFull), (long long)(out >> 32));
  }
}

// Up to k = 6, block b writes the positions of its set bits to
// pos[offsets[b] ..) in ascending order (the first HIT_CACHE of them to
// shared memory too), then its threads replay the NFA over the ``halo``
// symbols that end at each hit, a thread per (hit, limb). At k <= 1 the
// registers are held to 64, so that 8 blocks fit an SM; a thread holds its
// limb's K + 1 match and init words in registers. Past it (K = 8 .. 24) the
// kernel is the deep replay's second launch (replay_deep), behind
// hit_words_wide_kernel_positions.
template <int K, bool DAM>
__global__ void __launch_bounds__(WIDE_HITS_THREADS, K <= 1 ? 8 : K <= MAX_K ? 1 : K <= 16 ? 4 : 2)
hit_words_wide_kernel(const uint8_t* __restrict__ ids, long long n,
                      const uint32_t* __restrict__ bits, const int* __restrict__ offsets,
                      long long nblocks, Tables tb, int A, int W, int k, int halo,
                      long long* pos, long long* __restrict__ words) {
  if constexpr (K > MAX_K) {
    replay_deep<K, DAM>(ids, n, tb, A, W, k, halo, __ldg(offsets + nblocks), pos, words);
  } else {
    __shared__ int s_warp[WIDE_HITS_THREADS / 32];
    __shared__ long long s_pos[HIT_CACHE];

    BlockWords<WIDE_HITS_THREADS> mine;
    mine.load(bits);  // in flight beside the offsets
    const int base = offsets[blockIdx.x], next = offsets[blockIdx.x + 1];
    if (next == base) return;  // no hit in this block
    mine.positions(base, pos, s_warp, s_pos, HIT_CACHE);

    const int items = (next - base) * W;  // at most BLOCK_SYMS x WIDE_MAX_W
    for (int i = threadIdx.x; i < items; i += WIDE_HITS_THREADS) {
      const int h = i / W, w = i - h * W, r = base + h;
      const long long p = h < HIT_CACHE ? s_pos[h] : pos[r];
      uint64_t st = __ldg(tb.starts + w), nl = ~0ull;
      if constexpr (DAM) nl = __ldg(tb.notlast + w);
      uint64_t mt[K + 1], in[K + 1];
#pragma unroll
      for (int d = 0; d <= K; ++d) {  // rows past the call's k read as zero
        mt[d] = d <= k ? __ldg(tb.match + d * W + w) : 0ull;
        in[d] = d <= k ? __ldg(tb.init + d * W + w) : 0ull;
      }
      const uint64_t out = replay_limb<K, DAM>(ids, n, tb, A, W, w, k, halo, p, st, nl, in, mt);
      long long* dst = words + (long long)r * (2 * W) + 2 * w;
      dst[0] = (long long)(out & 0xFFFFFFFFull);
      dst[1] = (long long)(out >> 32);
    }
  }
}

// An instance's dynamic shared memory past the 48 KiB default: allowed once
// per device, at the instance's largest need, by its first launch that
// needs it (the attribute outlives the launch).
class SmemOptIn {
 public:
  template <typename Kern>
  cudaError_t allow(Kern kern, size_t need, size_t most) {
    if (need <= (size_t)SMEM_DEFAULT) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (devices_.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err == cudaSuccess) devices_.fetch_or(bit, std::memory_order_acq_rel);
    return err;
  }

 private:
  std::atomic<unsigned long long> devices_{0};
};

template <int LPL, int G, int K, bool DAM>
cudaError_t launch_scan(const Call& c, int W) {
  if (c.chunk != WIDE_CHUNK) return cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  auto kern = scan_bits_wide_kernel<LPL, G, K, DAM>;
  const size_t shm = K == 0 ? K0Row<LPL>::smem(c.A) : wide_smem(LPL * G, K);
  const size_t most = K == 0 ? K0Row<LPL>::smem(MAX_A) : shm;
  const cudaError_t err = opt_in.allow(kern, shm, most);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)c.nblocks, chains_of(G, K) * G, shm, c.stream>>>(
      c.ids, c.n, c.tb, c.A, W, c.k, c.halo, c.bits, c.counts);
  return cudaGetLastError();
}

// Blocks of hit_words_wide_kernel<K, DAM> (WIDE_HITS_THREADS threads) the
// card holds at once; the query runs once per instance.
template <int K, bool DAM>
long long resident_blocks() {
  static const long long blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hit_words_wide_kernel<K, DAM>,
                                                      WIDE_HITS_THREADS, 0) != cudaSuccess)
      return 0ll;
    return (long long)sms * per_sm;
  }();
  return blocks;
}

template <int K, bool DAM>
cudaError_t launch_hits(const Call& c, int W) {
  auto kern = hit_words_wide_kernel<K, DAM>;
  unsigned grid = (unsigned)c.nblocks;
  if constexpr (K > MAX_K) {
    hit_words_wide_kernel_positions<<<grid, WIDE_HITS_THREADS, 0, c.stream>>>(c.bits, c.counts,
                                                                             c.pos);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long resident = resident_blocks<K, DAM>();
    if (resident < 1) return cudaErrorInvalidConfiguration;
    grid = (unsigned)resident;
  }
  kern<<<grid, WIDE_HITS_THREADS, 0, c.stream>>>(c.ids, c.n, c.bits, c.counts, c.nblocks, c.tb,
                                                 c.A, W, c.k, c.halo, c.pos, c.words);
  return cudaGetLastError();
}

// An instance per exact row count k = 0, 1, 2, the masked ones for k = 3..6,
// 7..12 and 13..24, with the Damerau rows at k >= 1 where the call has
// ``notlast``.
template <int LPL, int G, int K>
cudaError_t launch_k(const Call& c, int W) {
  const bool dam = K >= 1 && c.tb.notlast != nullptr;
  if (c.hits) return dam ? launch_hits<K, K >= 1>(c, W) : launch_hits<K, false>(c, W);
  return dam ? launch_scan<LPL, G, K, K >= 1>(c, W) : launch_scan<LPL, G, K, false>(c, W);
}

template <int LPL, int G>
cudaError_t launch_fuzzy(const Call& c, int W) {
  switch (c.k) {
    case 1: return launch_k<LPL, G, 1>(c, W);
    case 2: return launch_k<LPL, G, 2>(c, W);
    default: return launch_k<LPL, G, MAX_K>(c, W);
  }
}

// The deep replay's row template for k = 7..24: the multiple of 4 >= k
// (8 .. 24), so that a replay steps at most 3 rows past k.
constexpr int replay_rows(int k) { return k <= 8 ? 8 : (k + 3) / 4 * 4; }

template <int K>
cudaError_t launch_replay(const Call& c, int W) {
  return c.tb.notlast != nullptr ? launch_hits<K, true>(c, W) : launch_hits<K, false>(c, W);
}

template <int LPL, int G>
cudaError_t launch_deep(const Call& c, int W) {
  if (c.hits) {
    switch (replay_rows(c.k)) {
      case 8: return launch_replay<8>(c, W);
      case 12: return launch_replay<12>(c, W);
      case 16: return launch_replay<16>(c, W);
      case 20: return launch_replay<20>(c, W);
      default: return launch_replay<MAX_KW>(c, W);
    }
  }
  return c.k <= 12 ? launch_k<LPL, G, 12>(c, W) : launch_k<LPL, G, MAX_KW>(c, W);
}

// The scan's instance table, (LPL, G) for W limbs at k: at k = 0 G0 lanes of
// ceil(W / G0) limbs; at k = 1..6 (2, 8) for W <= 16, (4, 8) for W <= 32,
// else (4, 16); at k = 7..24 one limb a lane, G the power of two >= W, up to
// W = 32, else (2, 32). ops/packed_bitap.py::wide_scan_instance mirrors it.
// The hit-word kernel has one instance per k up to 6, and past it one per
// replay_rows(k).
struct Shape {
  int lpl, g;
};

constexpr int pow2_at_least(int W) {
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16 : 32;
}

constexpr Shape wide_shape(int W, int k) {
  return k == 0       ? Shape{(W + G0 - 1) / G0, G0}
         : k > MAX_K  ? (W <= 32 ? Shape{1, pow2_at_least(W)} : Shape{2, 32})
         : W <= 16    ? Shape{2, 8}
         : W <= 32    ? Shape{4, 8}
                      : Shape{4, 16};
}

// Whether the wide kernels take W limbs at k rows: W = 9..64 at k <= 6,
// W = 1..64 at k = 7..24.
constexpr bool wide_ok(int W, int k) {
  return k >= 0 && k <= MAX_KW && W >= 1 && W <= WIDE_MAX_W && (W > MAX_W || k > MAX_K);
}

cudaError_t dispatch_wide(const Call& c, int W) {
  if (!call_ok(c, MAX_KW) || !wide_ok(W, c.k)) return cudaErrorInvalidValue;
  const Shape s = wide_shape(W, c.k);
  if (c.k > MAX_K) {
    if (s.lpl == 2) return launch_deep<2, 32>(c, W);
    switch (s.g) {
      case 1: return launch_deep<1, 1>(c, W);
      case 2: return launch_deep<1, 2>(c, W);
      case 4: return launch_deep<1, 4>(c, W);
      case 8: return launch_deep<1, 8>(c, W);
      case 16: return launch_deep<1, 16>(c, W);
      default: return launch_deep<1, 32>(c, W);
    }
  }
  if (c.k == 0) {
    switch (s.lpl) {
      case 2: return launch_k<2, G0, 0>(c, W);
      case 3: return launch_k<3, G0, 0>(c, W);
      case 4: return launch_k<4, G0, 0>(c, W);
      case 5: return launch_k<5, G0, 0>(c, W);
      case 6: return launch_k<6, G0, 0>(c, W);
      case 7: return launch_k<7, G0, 0>(c, W);
      default: return launch_k<8, G0, 0>(c, W);
    }
  }
  if (s.lpl == 2) return launch_fuzzy<2, 8>(c, W);
  if (s.g == 8) return launch_fuzzy<4, 8>(c, W);
  return launch_fuzzy<4, 16>(c, W);
}

}  // namespace

extern "C" {

// Symbols one chain of scan_bits_wide_kernel scans (the ``chunk`` its entry
// takes).
int fac_scan_wide_chunk() { return WIDE_CHUNK; }

// The scan's instance for W limbs at k: LPL * 256 + G, or -1 outside W =
// 9..64 at k = 0..6 and W = 1..64 at k = 7..24.
int fac_scan_wide_instance(int W, int k) {
  if (!wide_ok(W, k)) return -1;
  const Shape s = wide_shape(W, k);
  return s.lpl * 256 + s.g;
}

// As fac_scan_bits (packed_bitap.cu), for W = 9..64 at k = 0..6 and W =
// 1..64 at k = 7..24; chunk must be fac_scan_wide_chunk() (the deep
// instances of 16 and 32 lanes give a chain more, which the caller does not
// see).
int fac_scan_bits_wide(const void* ids, long long n, const void* tbl, const void* starts,
                       const void* match, const void* init, const void* notlast, int A, int W,
                       int k, int halo, int chunk, long long nblocks, void* bits, void* counts,
                       void* stream) {
  const Call c = make_call(false, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, chunk, bits, counts, nullptr, nullptr, stream);
  return (int)dispatch_wide(c, W);
}

// As fac_hit_words (packed_bitap.cu), for the tables fac_scan_bits_wide
// takes.
int fac_hit_words_wide(const void* ids, long long n, const void* bits, const void* offsets,
                       const void* tbl, const void* starts, const void* match,
                       const void* init, const void* notlast, int A, int W, int k, int halo,
                       long long nblocks, void* pos, void* words, void* stream) {
  const Call c = make_call(true, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, 0, bits, offsets, pos, words, stream);
  return (int)dispatch_wide(c, W);
}

}  // extern "C"
