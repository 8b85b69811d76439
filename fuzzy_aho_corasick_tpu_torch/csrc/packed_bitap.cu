// Packed multi-pattern shift-AND (Wu-Manber) NFA for Hopper (sm_90a): the
// ordered hit-list scan at W = 1..8 limbs and k = 0..6 (scan_wide.cu takes
// W = 9..64, and every W at k = 7..24).
//
// Replaces the JAX package's one Pallas kernel body
// (fuzzy_aho_corasick_tpu/ops/packed_bitap.py::_kernel_factory) in its two
// call shapes, and the compaction between them:
//
//   scan_bits_kernel     <- _pallas_scan  : one hit BIT per stream position
//                                           (u32 words, bit i of word j is
//                                           position 32 j + i) and the number
//                                           of hits of every block.
//   block_offsets_kernel <- the prefix sum of ops/compact.py: exclusive
//                                           offsets of the block counts; the
//                                           last entry is the hit count
//                                           (csrc/scan_offsets.cu).
//   hit_words_kernel     <- _replay_words : ascending hit positions and, for
//                                           each, the 2W u32 match words.
//
// What it computes. Pattern fields are packed into W (1..8) u64 limbs; a
// field never straddles a limb. Rows 0..k hold the error-budget states; with
// a ``notlast`` mask (Damerau) rows k+1..2k hold pending transpositions
// (swap = one error). Per symbol, with bc = word_tbl[sym] and u64 shifts
// (the Pallas kernel's u32 pairs with a carry are the same shift):
//
//   new[0] = ((prev[0] << 1) | starts) & bc
//   new[d] = ((prev[d] << 1) & bc) | ((prev[d-1] | new[d-1]) << 1)
//            | prev[d-1] | starts                                 (d >= 1)
//   Damerau, with bcn = (bc >> 1) & notlast and sbc = bc << 1:
//     new[d]   |= (pend[d] << 1) & sbc
//     pend'[d]  = ((prev[d-1] << 1) | starts) & bcn
//   match words = OR over d of new[d] & match[d]; hit = any word != 0.
//
// The code uses (pend << 1) & (bc << 1) == (pend & bc) << 1, so the
// transposition arrival shares the one shift of (prev[d-1] | new[d-1]).
//
// Semantics kept exactly (checklist):
//   * the recurrence above, ``starts`` ORed into every row >= 1, the notlast
//     guard for transpositions (packed_bitap.py:434-477);
//   * symbol 0 is dead, and reads before the stream start (and past its
//     end) are symbol 0: the fresh state's fixpoint (packed_bitap.py:521-531);
//   * every chain starts from the fresh state (init rows, empty pending
//     rows) ``halo`` symbols before the first position it reports, the same
//     warm-up the Pallas lanes and replay windows use;
//   * hit positions come out ascending (packed_bitap.py:802-807): bits are
//     kept in stream order and turned into positions block by block behind
//     an exclusive scan of the block counts;
//   * positions >= n carry no bit; hits on a caller's padded tail inside n
//     are reported, and the caller drops them by ``pos < n_real``.
//
// What bounds it on the H100. The scan reads 1 byte and writes 1 bit per
// symbol of device memory, but needs about 14 integer instructions per
// 32-bit state word and symbol at k = 1 with Damerau rows (a u64 limb op is
// two of them), so at every table shape it is bound by the integer
// instruction rate, not by bytes. Its design: no per-symbol output (bits,
// not bytes, and no library compaction pass behind it); an instance per
// exact row count k = 0, 1, 2 (k = 3..6 share one instance that masks rows at
// run time), so no row is carried that the call does not use; one thread
// scans one contiguous chunk, read 16 bytes at a time straight from global
// memory one round ahead (the sectors are used in full, and without a
// staging buffer the block's shared memory is the 3 KiB of tables, so
// registers alone set the occupancy; two interleaved chunks per thread
// measured slower than one, for the registers they take, and neither a hit
// test per four symbols nor the match masks in registers moved the time);
// the chunk length is the caller's (a launch parameter, the block's thread
// count follows from it): long chunks spend less on the warm-up, short ones
// give a small stream enough threads to fill the card, so the wrapper picks
// it from the stream's length and the card's size;
// the [A, W] u64 word table sits in shared memory
// (one lookup per limb per symbol: the TPU kernel's per-class select loop
// and baked constants existed because the TPU had no cheap gather).
// hit_words_kernel replays the NFA over the ``halo`` symbols behind each
// hit; a block first writes its positions in order, then deals its hits out
// to its threads, so a run of hits costs one replay's latency. Hits are
// ~1e-3 of positions, so it is small beside the scan.

#include "packed_bitap.cuh"

namespace {

using namespace fac_scan;

// Loads the tables shared by both kernels into shared memory / registers.
// Rows past the call's k (the masked instance) read as zero.
template <int W, int K>
__device__ __forceinline__ void load_tables(const Tables& tb, int A, int k,
                                            uint64_t* s_tbl, uint64_t* s_match,
                                            uint64_t* s_init, uint64_t* st,
                                            uint64_t* nl, int tid, int nthreads) {
  for (int i = tid; i < A * W; i += nthreads) s_tbl[i] = tb.tbl[i];
  for (int i = A * W + tid; i < MAX_A * W; i += nthreads) s_tbl[i] = 0ull;
  for (int i = tid; i < (K + 1) * W; i += nthreads) {
    const bool live = i / W <= k;
    s_match[i] = live ? tb.match[i] : 0ull;
    s_init[i] = live ? tb.init[i] : 0ull;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    st[w] = tb.starts[w];
    nl[w] = tb.notlast != nullptr ? tb.notlast[w] : ~0ull;
  }
}

// One thread scans ``chunk`` symbols; the block of BLOCK_SYMS / chunk
// threads covers BLOCK_SYMS.
template <int W, int K, bool DAM>
__global__ void __launch_bounds__(SCAN_THREADS_MAX)
scan_bits_kernel(const uint8_t* __restrict__ ids, long long n, Tables tb,
                 int A, int k, int halo, int chunk, uint32_t* __restrict__ bits,
                 int* __restrict__ block_counts) {
  const int THREADS = blockDim.x;  // BLOCK_SYMS / chunk
  __shared__ uint64_t s_tbl[MAX_A * W];
  __shared__ uint64_t s_match[(K + 1) * W];
  __shared__ uint64_t s_init[(K + 1) * W];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  uint64_t st[W], nl[W];
  load_tables<W, K>(tb, A, k, s_tbl, s_match, s_init, st, nl, tid, THREADS);
  if (tid == 0) s_count = 0;
  __syncthreads();

  // This thread reports positions [c0, c0 + chunk), warmed up from the
  // fresh state over [c0 - halo, c0).
  const long long c0 = ((long long)blockIdx.x * THREADS + tid) * chunk;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  int hits = 0;
  if (c0 < n) {
    Nfa<W, K, DAM> nfa;
    nfa.reset(s_init, k);
    for (int q = -halo; q < 0; ++q)
      nfa.step_any(s_tbl, sym_at(ids, n, c0 + q), st, nl, s_match, k);
    // 16 symbols a round; the next round's bytes are loaded before this
    // round's are stepped through.
    uint4 cur = load16(ids, n, c0, aligned), nxt = cur;
    uint32_t word = 0u;
    const int rounds = chunk / 16;
#pragma unroll 1
    for (int h = 0; h < rounds; ++h) {
      if (h + 1 < rounds) nxt = load16(ids, n, c0 + (h + 1) * 16, aligned);
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        const uint32_t four = pick(cur, j);
        uint32_t nib = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool hit = nfa.step_any(s_tbl, (four >> (8 * i)) & 0xFF, st, nl, s_match, k);
          nib |= (hit ? 1u : 0u) << i;
        }
        word |= nib << ((h & 1) * 16 + j * 4);
      }
      cur = nxt;
      if (h & 1) {
        const long long p = c0 + (h / 2) * 32;
        const uint32_t out = clip_word(word, p, n);
        bits[p / 32] = out;
        hits += __popc(out);
        word = 0u;
      }
    }
  } else {
    for (int t = 0; t < chunk / 32; ++t) bits[c0 / 32 + t] = 0u;
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xFFFFFFFFu, hits, o);
  if ((tid & 31) == 0 && hits != 0) atomicAdd(&s_count, hits);
  __syncthreads();
  if (tid == 0) block_counts[blockIdx.x] = s_count;
}

// Block b turns the set bits of its BLOCK_WORDS bit words into positions
// pos[offsets[b] ..) in ascending order and replays the NFA over the
// ``halo`` symbols that end at each of them.
template <int W, int K, bool DAM>
__global__ void __launch_bounds__(HITS_THREADS)
hit_words_kernel(const uint8_t* __restrict__ ids, long long n,
                 const uint32_t* __restrict__ bits,
                 const int* __restrict__ offsets, Tables tb, int A, int k,
                 int halo, long long* pos, long long* __restrict__ words) {
  __shared__ uint64_t s_tbl[MAX_A * W];
  __shared__ uint64_t s_match[(K + 1) * W];
  __shared__ uint64_t s_init[(K + 1) * W];
  __shared__ int s_warp[HITS_THREADS / 32];

  const int tid = threadIdx.x;
  const int base = offsets[blockIdx.x], next = offsets[blockIdx.x + 1];
  if (next == base) return;  // no hit in this block
  uint64_t st[W], nl[W];
  load_tables<W, K>(tb, A, k, s_tbl, s_match, s_init, st, nl, tid, HITS_THREADS);

  block_positions(bits, base, pos, s_warp);
  for (int r = base + tid; r < next; r += HITS_THREADS) {
    const long long p = pos[r];
    Nfa<W, K, DAM> nfa;
    nfa.reset(s_init, k);
    uint64_t out[W];
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = 0ull;
    // Replay ids[p - halo + 1 .. p] from the fresh state; reads outside
    // the stream are the dead symbol 0.
    for (long long q = p - halo + 1; q <= p; ++q)
      nfa.step(s_tbl, sym_at(ids, n, q), st, nl, s_match, k, out);
    long long* dst = words + (long long)r * (2 * W);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dst[2 * w] = (long long)(out[w] & 0xFFFFFFFFull);
      dst[2 * w + 1] = (long long)(out[w] >> 32);
    }
  }
}

template <int W, int K, bool DAM>
cudaError_t launch_scan(const Call& c) {
  if (c.chunk < CHUNK_MIN || c.chunk > CHUNK_MAX || c.chunk % 32 != 0 ||
      BLOCK_SYMS % c.chunk != 0 || (BLOCK_SYMS / c.chunk) % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  scan_bits_kernel<W, K, DAM><<<(unsigned)c.nblocks, BLOCK_SYMS / c.chunk, 0, c.stream>>>(
      c.ids, c.n, c.tb, c.A, c.k, c.halo, c.chunk, c.bits, c.counts);
  return cudaGetLastError();
}

template <int W, int K, bool DAM>
cudaError_t launch_hits(const Call& c) {
  hit_words_kernel<W, K, DAM><<<(unsigned)c.nblocks, HITS_THREADS, 0, c.stream>>>(
      c.ids, c.n, c.bits, c.counts, c.tb, c.A, c.k, c.halo, c.pos, c.words);
  return cudaGetLastError();
}

template <int W, int K>
cudaError_t launch_k(const Call& c) {
  if (K >= 1 && c.tb.notlast != nullptr)
    return c.hits ? launch_hits<W, K, K >= 1>(c) : launch_scan<W, K, K >= 1>(c);
  return c.hits ? launch_hits<W, K, false>(c) : launch_scan<W, K, false>(c);
}

// One instance per exact row count k = 0, 1, 2; k = 3..6 share the masked one.
template <int W>
cudaError_t launch_w(const Call& c) {
  switch (c.k) {
    case 0: return launch_k<W, 0>(c);
    case 1: return launch_k<W, 1>(c);
    case 2: return launch_k<W, 2>(c);
    default: return launch_k<W, MAX_K>(c);
  }
}

cudaError_t dispatch(const Call& c, int W) {
  if (!call_ok(c, MAX_K) || W < 1 || W > MAX_W) return cudaErrorInvalidValue;
  switch (W) {
    case 1: return launch_w<1>(c);
    case 2: return launch_w<2>(c);
    case 3: return launch_w<3>(c);
    case 4: return launch_w<4>(c);
    case 5: return launch_w<5>(c);
    case 6: return launch_w<6>(c);
    case 7: return launch_w<7>(c);
    case 8: return launch_w<8>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Stream positions one block of the scan covers; the callers size ``bits``
// (nblocks * fac_scan_block_syms() / 32 words) and ``counts`` from it.
int fac_scan_block_syms() { return BLOCK_SYMS; }

// ids: u8 [n]; chunk: symbols per thread (128, 256 or 512); bits: u32
// [nblocks * BLOCK_SYMS / 32], every word written; counts: int32 [nblocks].
// Tables are u64 (see Tables). Returns the launch's cudaError_t (0 =
// launched).
int fac_scan_bits(const void* ids, long long n, const void* tbl,
                  const void* starts, const void* match, const void* init,
                  const void* notlast, int A, int W, int k, int halo, int chunk,
                  long long nblocks, void* bits, void* counts, void* stream) {
  const Call c = make_call(false, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, chunk, bits, counts, nullptr, nullptr, stream);
  return (int)dispatch(c, W);
}

// bits and offsets as the two kernels above wrote them; pos: int64 [hits];
// words: int64 [hits, 2W] holding the u32 halves (low, high) of each limb's
// match word.
int fac_hit_words(const void* ids, long long n, const void* bits,
                  const void* offsets, const void* tbl, const void* starts,
                  const void* match, const void* init, const void* notlast,
                  int A, int W, int k, int halo, long long nblocks, void* pos,
                  void* words, void* stream) {
  const Call c = make_call(true, ids, n, nblocks, tbl, starts, match, init, notlast, A, k,
                           halo, 0, bits, offsets, pos, words, stream);
  return (int)dispatch(c, W);
}

const char* fac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
