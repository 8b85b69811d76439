// Packed multi-pattern shift-AND (Wu-Manber) NFA for Hopper (sm_90a): the
// ordered hit-list scan at W = 9..64 u64 limbs.
//
// Replaces the traced-table form of the JAX package's one Pallas kernel body
// (fuzzy_aho_corasick_tpu/ops/packed_bitap.py::_kernel_factory with
// consts=None: tables in SMEM, the Damerau recurrence switched on by a traced
// ``notlast``) in its two call shapes, at the widths the large-dictionary
// lane (fuzzy_aho_corasick_tpu/ops/many.py) scans with:
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
// What bounds it on the H100. At W = 31 with k = 1 under the Damerau rows a
// chain carries 31 x 3 u64 words of state, 186 registers: one thread per
// chain, as the narrow kernel runs it, cannot hold it, and the recurrence
// is ~870 integer instructions per symbol, so the scan is bound by the
// integer instruction rate, never by the 1 byte per symbol it reads. No field
// straddles a limb and ``notlast`` is per limb, so limbs are independent:
// a chain is a group of G lanes of one warp (G = 8 or 16), each stepping the
// same symbols (the same 16-byte loads, one transaction for the group) on
// its own LPL limbs (2 or 4), with the state in registers. Once per 32
// symbols the group ORs its hit words with shuffles and its first lane
// writes the bit word. Every chain runs the same number of steps (chains past
// the stream read symbol 0 and write zero words), so the shuffles never meet
// a diverged warp. The [A, W] word table, padded to G x LPL limbs with zero
// columns, sits in dynamic shared memory (18-73 KiB; above 48 KiB the launch
// opts in). One chain scans WIDE_CHUNK symbols after its ``halo`` warm-up.
// hit_words_wide_kernel writes a block's positions as hit_words_kernel
// does, then deals its hits out to its groups, each lane replaying its limbs.
// Instances: (LPL, G) = (2, 8) for W = 9..16, (4, 8) for 17..32 and (4, 16)
// for 33..64, each for k = 0, 1, 2 and the run-time-masked k = 3..6, with
// and without the Damerau rows.

#include "packed_bitap.cuh"

namespace {

using namespace fac_scan;

constexpr int WIDE_CHUNK = 512;                           // symbols per chain
constexpr int WIDE_CHAINS = BLOCK_SYMS / WIDE_CHUNK;      // chains per block
constexpr int WIDE_MAX_W = 64;
constexpr int SMEM_DEFAULT = 48 * 1024;

// Dynamic shared memory of an instance: the [MAX_A, WP] word table and the
// [K + 1, WP] match and init rows.
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

// A block of WIDE_CHAINS chains of G lanes covers BLOCK_SYMS symbols.
template <int LPL, int G, int K, bool DAM>
__global__ void __launch_bounds__(WIDE_CHAINS * G)
scan_bits_wide_kernel(const uint8_t* __restrict__ ids, long long n, Tables tb, int A, int W,
                      int k, int halo, uint32_t* __restrict__ bits,
                      int* __restrict__ block_counts) {
  constexpr int WP = LPL * G;
  constexpr int THREADS = WIDE_CHAINS * G;
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

  // This chain reports positions [c0, c0 + WIDE_CHUNK), warmed up from the
  // fresh state over [c0 - halo, c0); this lane holds limbs l0 .. l0+LPL-1.
  const long long c0 = ((long long)blockIdx.x * WIDE_CHAINS + chain) * WIDE_CHUNK;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  const uint64_t* m0 = s_match + l0;
  Nfa<LPL, K, DAM> nfa;
  nfa.reset(s_init + l0, WP);
  for (int q = -halo; q < 0; ++q)
    nfa.step_any_row(s_tbl + (sym_at(ids, n, c0 + q) & (MAX_A - 1)) * WP + l0, st, nl, m0, k,
                     WP);
  uint4 cur = load16(ids, n, c0, aligned), nxt = cur;
  uint32_t word = 0u;
  int hits = 0;
  constexpr int rounds = WIDE_CHUNK / 16;
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
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) word |= __shfl_xor_sync(0xFFFFFFFFu, word, o);
      if (lane == 0) {
        const long long p = c0 + (h / 2) * 32;
        const uint32_t out = clip_word(word, p, n);
        bits[p / 32] = out;
        hits += __popc(out);
      }
      word = 0u;
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xFFFFFFFFu, hits, o);
  if ((tid & 31) == 0 && hits != 0) atomicAdd(&s_count, hits);
  __syncthreads();
  if (tid == 0) block_counts[blockIdx.x] = s_count;
}

// Block b writes the positions of its set bits to pos[offsets[b] ..) in
// ascending order, then its groups of G lanes replay the NFA over the
// ``halo`` symbols that end at each hit, a lane per LPL limbs.
template <int LPL, int G, int K, bool DAM>
__global__ void __launch_bounds__(HITS_THREADS)
hit_words_wide_kernel(const uint8_t* __restrict__ ids, long long n,
                      const uint32_t* __restrict__ bits, const int* __restrict__ offsets,
                      Tables tb, int A, int W, int k, int halo, long long* pos,
                      long long* __restrict__ words) {
  constexpr int WP = LPL * G;
  extern __shared__ uint64_t s_wide[];
  uint64_t* s_tbl = s_wide;
  uint64_t* s_match = s_tbl + MAX_A * WP;
  uint64_t* s_init = s_match + (K + 1) * WP;
  __shared__ int s_warp[HITS_THREADS / 32];

  const int tid = threadIdx.x;
  const int base = offsets[blockIdx.x], next = offsets[blockIdx.x + 1];
  if (next == base) return;  // no hit in this block
  load_wide_tables<WP, K>(tb, A, W, k, s_tbl, s_match, s_init, tid, HITS_THREADS);
  block_positions(bits, base, pos, s_warp);

  const int lane = tid % G, l0 = lane * LPL;
  uint64_t st[LPL], nl[LPL];
  lane_masks<LPL>(tb, W, l0, st, nl);
  for (int r = base + tid / G; r < next; r += HITS_THREADS / G) {
    const long long p = pos[r];
    Nfa<LPL, K, DAM> nfa;
    nfa.reset(s_init + l0, WP);
    uint64_t out[LPL];
#pragma unroll
    for (int j = 0; j < LPL; ++j) out[j] = 0ull;
    // Replay ids[p - halo + 1 .. p] from the fresh state; reads outside the
    // stream are the dead symbol 0.
    for (long long q = p - halo + 1; q <= p; ++q)
      nfa.step_row(s_tbl + (sym_at(ids, n, q) & (MAX_A - 1)) * WP + l0, st, nl, s_match + l0,
                   k, out, WP);
    long long* dst = words + (long long)r * (2 * W);
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const int w = l0 + j;
      if (w < W) {
        dst[2 * w] = (long long)(out[j] & 0xFFFFFFFFull);
        dst[2 * w + 1] = (long long)(out[j] >> 32);
      }
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t shm) {
  if (shm <= (size_t)SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

template <int LPL, int G, int K, bool DAM>
cudaError_t launch_wide(const Call& c, int W) {
  constexpr size_t shm = wide_smem(LPL * G, K);
  cudaError_t err;
  if (c.hits) {
    auto kern = hit_words_wide_kernel<LPL, G, K, DAM>;
    if ((err = allow_smem(kern, shm)) != cudaSuccess) return err;
    kern<<<(unsigned)c.nblocks, HITS_THREADS, shm, c.stream>>>(
        c.ids, c.n, c.bits, c.counts, c.tb, c.A, W, c.k, c.halo, c.pos, c.words);
  } else {
    if (c.chunk != WIDE_CHUNK) return cudaErrorInvalidValue;
    auto kern = scan_bits_wide_kernel<LPL, G, K, DAM>;
    if ((err = allow_smem(kern, shm)) != cudaSuccess) return err;
    kern<<<(unsigned)c.nblocks, WIDE_CHAINS * G, shm, c.stream>>>(
        c.ids, c.n, c.tb, c.A, W, c.k, c.halo, c.bits, c.counts);
  }
  return cudaGetLastError();
}

template <int LPL, int G, int K>
cudaError_t launch_wide_k(const Call& c, int W) {
  if (K >= 1 && c.tb.notlast != nullptr) return launch_wide<LPL, G, K, K >= 1>(c, W);
  return launch_wide<LPL, G, K, false>(c, W);
}

template <int LPL, int G>
cudaError_t launch_shape(const Call& c, int W) {
  switch (c.k) {
    case 0: return launch_wide_k<LPL, G, 0>(c, W);
    case 1: return launch_wide_k<LPL, G, 1>(c, W);
    case 2: return launch_wide_k<LPL, G, 2>(c, W);
    default: return launch_wide_k<LPL, G, MAX_K>(c, W);
  }
}

cudaError_t dispatch_wide(const Call& c, int W) {
  if (!call_ok(c) || W <= MAX_W || W > WIDE_MAX_W) return cudaErrorInvalidValue;
  if (W <= 16) return launch_shape<2, 8>(c, W);
  if (W <= 32) return launch_shape<4, 8>(c, W);
  return launch_shape<4, 16>(c, W);
}

}  // namespace

extern "C" {

// Symbols one chain of scan_bits_wide_kernel scans (the ``chunk`` its entry
// takes).
int fac_scan_wide_chunk() { return WIDE_CHUNK; }

// As fac_scan_bits (packed_bitap.cu), for W = 9..64; chunk must be
// fac_scan_wide_chunk().
int fac_scan_bits_wide(const void* ids, long long n, const void* tbl, const void* starts,
                       const void* match, const void* init, const void* notlast, int A, int W,
                       int k, int halo, int chunk, long long nblocks, void* bits, void* counts,
                       void* stream) {
  const Call c = make_call(false, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, chunk, bits, counts, nullptr, nullptr, stream);
  return (int)dispatch_wide(c, W);
}

// As fac_hit_words (packed_bitap.cu), for W = 9..64.
int fac_hit_words_wide(const void* ids, long long n, const void* bits, const void* offsets,
                       const void* tbl, const void* starts, const void* match,
                       const void* init, const void* notlast, int A, int W, int k, int halo,
                       long long nblocks, void* pos, void* words, void* stream) {
  const Call c = make_call(true, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, 0, bits, offsets, pos, words, stream);
  return (int)dispatch_wide(c, W);
}

}  // extern "C"
