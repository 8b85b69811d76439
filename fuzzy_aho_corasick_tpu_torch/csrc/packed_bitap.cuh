// Shared device code of the packed shift-AND scan (see packed_bitap.cu for
// what it computes and the semantics it keeps): the tables, the per-chain NFA
// state, the stream loads, and the positions step of the hit-word kernels.
// Included by packed_bitap.cu (W = 1..8 limbs at k <= 6, one thread per
// chain) and scan_wide.cu (W = 9..64 limbs at k <= 6, and W = 1..64 at
// k = 7..24, a group of lanes per chain), so both run the same recurrence.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fac_scan {

constexpr int BLOCK_SYMS = 16384;    // stream symbols per block of the scan
constexpr int BLOCK_WORDS = BLOCK_SYMS / 32;
// Symbols one thread scans, the caller's choice within these limits: a
// multiple of 32 (whole bit words) that gives the block whole warps.
constexpr int CHUNK_MIN = 128, CHUNK_MAX = 512;
constexpr int SCAN_THREADS_MAX = BLOCK_SYMS / CHUNK_MIN;
constexpr int HITS_THREADS = 256;
constexpr int HALO_MAX = 128;
constexpr int MAX_A = 128;
constexpr int MAX_W = 8;
constexpr int MAX_K = 6;    // error rows of the one-thread chains (packed_bitap.cu)
constexpr int MAX_KW = 24;  // error rows of the lane-group chains (scan_wide.cu)

static_assert(CHUNK_MIN % 32 == 0 && BLOCK_SYMS % CHUNK_MAX == 0 &&
              (BLOCK_SYMS / CHUNK_MAX) % 32 == 0, "whole bit words and whole warps");

struct Tables {
  const uint64_t* tbl;      // [A, W] per-symbol limb words (symbol 0 all-zero)
  const uint64_t* starts;   // [W] bit 0 of every field
  const uint64_t* match;    // [k + 1, W] last bit of every field, per row
  const uint64_t* init;     // [k + 1, W] fresh-start state
  const uint64_t* notlast;  // [W] every field's last bit cleared, or null
};

// Per-chain NFA state over W limbs. K is the row count the instance is built
// for: for K <= 2 the call's k equals K; an instance with K > 2 (6, 12, 24)
// serves every k above the next smaller instance up to K and masks the rows
// past k at run time: they hold 0, and no table row past k is read. Every
// array index is static, so the state stays in registers. ``stride`` is the
// limb count of a row of the tables the chain reads (W itself, the padded
// width of the wide kernels, whose chains hold a slice of the limbs, or the
// table's own width where a thread reads one limb of it).
template <int W, int K, bool DAM>
struct Nfa {
  static constexpr int ROWS = (K + 1) + (DAM ? K : 0);
  static constexpr bool MASKED = K > 2;
  uint64_t r[ROWS][W];

  __device__ __forceinline__ void reset(const uint64_t* s_init, int k, int stride = W) {
#pragma unroll
    for (int d = 0; d <= K; ++d)
#pragma unroll
      for (int w = 0; w < W; ++w) r[d][w] = (!MASKED || d <= k) ? s_init[d * stride + w] : 0ull;
#pragma unroll
    for (int d = K + 1; d < ROWS; ++d)
#pragma unroll
      for (int w = 0; w < W; ++w) r[d][w] = 0ull;
  }

  // Advance one symbol whose limb words are ``row``; out[w] = OR over rows
  // of (new & match) for limb w. Without MATCH only the state advances
  // (``s_match`` and ``out`` are not read).
  template <bool MATCH = true>
  __device__ __forceinline__ void step_row(const uint64_t* row, const uint64_t* st,
                                           const uint64_t* nl, const uint64_t* s_match,
                                           int k, uint64_t* out, int stride = W) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t bc = row[w];
      const uint64_t old0 = r[0][w];
      uint64_t x = (old0 << 1) | st[w];  // ((prev[d-1] << 1) | starts), d = 1
      const uint64_t n0 = x & bc;
      r[0][w] = n0;
      uint64_t acc = 0ull;
      if constexpr (MATCH) acc = n0 & s_match[w];
      uint64_t bcn = 0;
      if constexpr (DAM) bcn = (bc >> 1) & nl[w];
      uint64_t prev_dm1 = old0, new_dm1 = n0;
#pragma unroll
      for (int d = 1; d <= K; ++d) {
        if (!MASKED || d <= k) {
          const uint64_t old = r[d][w];
          uint64_t carry = prev_dm1 | new_dm1;
          if constexpr (DAM) {
            carry |= r[K + d][w] & bc;
            r[K + d][w] = x & bcn;
          }
          const uint64_t nd = ((old << 1) & bc) | (carry << 1) | prev_dm1 | st[w];
          r[d][w] = nd;
          if constexpr (MATCH) acc |= nd & s_match[d * stride + w];
          x = (old << 1) | st[w];
          prev_dm1 = old;
          new_dm1 = nd;
        }
      }
      if constexpr (MATCH) out[w] = acc;
    }
  }

  __device__ __forceinline__ void step(const uint64_t* s_tbl, int sym, const uint64_t* st,
                                       const uint64_t* nl, const uint64_t* s_match, int k,
                                       uint64_t* out) {
    step_row(s_tbl + (sym & (MAX_A - 1)) * W, st, nl, s_match, k, out);
  }

  // Advance one symbol; whether some field's match bit is set.
  __device__ __forceinline__ bool step_any_row(const uint64_t* row, const uint64_t* st,
                                               const uint64_t* nl, const uint64_t* s_match,
                                               int k, int stride = W) {
    uint64_t out[W];
    step_row(row, st, nl, s_match, k, out, stride);
    uint64_t any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) any |= out[w];
    return any != 0;
  }

  __device__ __forceinline__ bool step_any(const uint64_t* s_tbl, int sym, const uint64_t* st,
                                           const uint64_t* nl, const uint64_t* s_match, int k) {
    return step_any_row(s_tbl + (sym & (MAX_A - 1)) * W, st, nl, s_match, k);
  }
};

__device__ __forceinline__ int sym_at(const uint8_t* __restrict__ ids, long long n,
                                      long long q) {
  return (q >= 0 && q < n) ? (int)__ldg(ids + q) : 0;
}

// Stream bytes [g, g + 16) as four little-endian words; bytes outside the
// stream read as 0. One 16-byte load where the address allows it.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ ids, long long n,
                                        long long g, bool aligned) {
  if (aligned && g >= 0 && g + 16 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(ids + g));
  }
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) word |= (uint32_t)sym_at(ids, n, g + 4 * j + b) << (8 * b);
    v[j] = word;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pick(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Bits of positions >= n cleared from the word that covers [p, p + 32).
__device__ __forceinline__ uint32_t clip_word(uint32_t word, long long p, long long n) {
  if (p >= n) return 0u;
  if (p + 32 > n) return word & ((1u << (int)(n - p)) - 1u);
  return word;
}

// The positions step of the hit-word kernels, for a block of THREADS
// threads: ``load`` reads this thread's share of block b's BLOCK_WORDS bit
// words (a kernel may issue it before it knows whether the block has a
// hit); ``positions`` writes the positions of their set bits to
// pos[base ..) in ascending order, and with ``s_pos`` those of the first
// ``cap`` ranks to s_pos[rank] too. Every thread of the block calls it; it
// starts and ends with a barrier, so shared-memory tables stored before it
// and the positions written by it are visible to the whole block after it.
template <int THREADS>
struct BlockWords {
  static constexpr int N = BLOCK_WORDS / THREADS;  // bit words per thread
  static_assert(BLOCK_WORDS % THREADS == 0 && N >= 1 && THREADS % 32 == 0,
                "every thread gets the same number of bit words");
  uint32_t w[N];

  __device__ __forceinline__ long long word0() const {
    return (long long)blockIdx.x * BLOCK_WORDS + threadIdx.x * N;
  }

  __device__ __forceinline__ void load(const uint32_t* __restrict__ bits) {
#pragma unroll
    for (int j = 0; j < N; ++j) w[j] = bits[word0() + j];
  }

  __device__ __forceinline__ void positions(int base, long long* pos, int* s_warp,
                                            long long* s_pos = nullptr, int cap = 0) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += __popc(w[j]);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // also orders the table loads before the replays
    int rank = incl - cnt;
    for (int v = 0; v < warp; ++v) rank += s_warp[v];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t m = w[j];
      while (m != 0) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        const long long p = (word0() + j) * 32 + bit;
        pos[base + rank] = p;
        if (s_pos != nullptr && rank < cap) s_pos[rank] = p;
        ++rank;
      }
    }
    __syncthreads();  // the block's positions are written
  }
};

// The positions step of hit_words_kernel (a block of HITS_THREADS threads).
__device__ __forceinline__ void block_positions(const uint32_t* __restrict__ bits, int base,
                                                long long* pos, int* s_warp) {
  BlockWords<HITS_THREADS> words;
  words.load(bits);
  words.positions(base, pos, s_warp);
}

struct Call {
  bool hits;  // false: the scan kernel, true: the hit-word kernel
  const uint8_t* ids;
  long long n, nblocks;
  Tables tb;
  int A, k, halo;
  int chunk;  // symbols per chain of the scan
  uint32_t* bits;
  int* counts;  // block counts (scan) or their exclusive offsets (hits)
  long long* pos;
  long long* words;
  cudaStream_t stream;
};

// Whether a call's shapes are inside what every scan kernel takes, at up to
// ``kmax`` error rows; W is checked by the caller against its own limb range.
inline bool call_ok(const Call& c, int kmax) {
  return c.A >= 1 && c.A <= MAX_A && c.k >= 0 && c.k <= kmax && c.halo >= 1 &&
         c.halo <= HALO_MAX && c.n >= 1 && c.nblocks == (c.n + BLOCK_SYMS - 1) / BLOCK_SYMS &&
         c.nblocks <= 0x7FFFFFFFll;
}

inline Call make_call(bool hits, const void* ids, long long n, long long nblocks,
                      const void* tbl, const void* starts, const void* match,
                      const void* init, const void* notlast, int A, int k, int halo,
                      int chunk, const void* bits, const void* counts, void* pos,
                      void* words, void* stream) {
  return Call{hits, static_cast<const uint8_t*>(ids), n, nblocks,
              Tables{static_cast<const uint64_t*>(tbl), static_cast<const uint64_t*>(starts),
                     static_cast<const uint64_t*>(match), static_cast<const uint64_t*>(init),
                     static_cast<const uint64_t*>(notlast)},
              A, k, halo, chunk,
              static_cast<uint32_t*>(const_cast<void*>(bits)),
              static_cast<int*>(const_cast<void*>(counts)),
              static_cast<long long*>(pos), static_cast<long long*>(words),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace fac_scan
