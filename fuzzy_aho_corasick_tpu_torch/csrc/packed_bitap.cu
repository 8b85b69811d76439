// Packed multi-pattern shift-AND (Wu-Manber) NFA for Hopper (sm_90a).
//
// Replaces the JAX package's one Pallas kernel body
// (fuzzy_aho_corasick_tpu/ops/packed_bitap.py::_kernel_factory) in its two
// call shapes:
//
//   scan_flags_kernel   <- _pallas_scan   : one u8 any-hit flag per stream
//                                           position, in stream order.
//   replay_words_kernel <- _replay_words  : for each compacted hit, the 2W
//                                           u32 match words at that position.
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
//   match words = OR over d of new[d] & match[d]; flag = any word != 0.
//
// Semantics kept exactly (checklist):
//   * the recurrence above, ``starts`` ORed into every row >= 1, the notlast
//     guard and sbc/bcn for transpositions (packed_bitap.py:434-477);
//   * symbol 0 is dead, and reads before the stream start (and past its
//     end) are symbol 0: the fresh state's fixpoint (packed_bitap.py:521-531);
//   * every thread starts from the fresh state (init rows, empty pending
//     rows) ``halo`` symbols before the first position it reports, the same
//     warm-up the Pallas lanes and replay windows use;
//   * flags come out in stream order, so compaction yields ascending hit
//     positions (packed_bitap.py:802-807);
//   * flags over the padded tail are computed; the host drops them by
//     ``pos < n``.
//
// What bounds it on the H100. The scan touches 1 byte read and 1 byte
// written per symbol of device memory and does O(W * k) integer ops per
// symbol, so at small W and k it is bound by device-memory bytes, and by
// integer issue beyond that. Its design: one thread owns one contiguous
// chunk of SCAN_CHUNK symbols; a block stages its SCAN_THREADS chunks plus
// the left halo into shared memory with coalesced 16-byte loads (neighbouring
// threads own far-apart chunks, so reading their bytes straight from global
// memory would not coalesce), padded by 4 bytes per chunk so the per-thread
// reads hit distinct banks; the [A, W] u64 word table sits in shared memory
// (one lookup per limb per symbol: the TPU kernel's per-class select loop
// and baked constants existed because the TPU had no cheap gather); flags
// are kept as bits in shared memory and written out as coalesced 16-byte
// stores. The replay kernel is one thread per hit over ``halo`` u8 reads;
// hits are ~1e-3 of positions, so it is small beside the scan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_CHUNK = 256;  // stream symbols each thread reports
constexpr int HALO_MAX = 128;    // staged left halo; callers need halo <= it
constexpr int BLOCK_SYMS = SCAN_THREADS * SCAN_CHUNK;
constexpr int STAGE_SYMS = HALO_MAX + BLOCK_SYMS;
constexpr int STAGE_BYTES = STAGE_SYMS + 4 * (STAGE_SYMS / SCAN_CHUNK + 1);
constexpr int BITS_WORDS = BLOCK_SYMS / 32;
constexpr int REPLAY_THREADS = 128;
constexpr int MAX_A = 128;
constexpr int MAX_W = 8;
constexpr int MAX_K = 6;

static_assert(HALO_MAX % 16 == 0 && SCAN_CHUNK % 32 == 0, "staging layout");

// Shared-memory offset of staged byte r: 4 pad bytes after every chunk, so
// thread i reading its byte j lands on bank (i + j / 4) mod 32.
__device__ __forceinline__ int swz(int r) { return r + 4 * (r / SCAN_CHUNK); }

struct Tables {
  const uint64_t* tbl;      // [A, W] per-symbol limb words (symbol 0 all-zero)
  const uint64_t* starts;   // [W] bit 0 of every field
  const uint64_t* match;    // [k + 1, W] last bit of every field, per row
  const uint64_t* init;     // [k + 1, W] fresh-start state
  const uint64_t* notlast;  // [W] every field's last bit cleared, or null
};

// Per-thread NFA state. KMAX is the row count the instance is built for;
// the runtime budget k <= KMAX masks the rows past it, so every array index
// is static and the state stays in registers.
template <int W, int KMAX, bool DAM>
struct Nfa {
  static constexpr int ROWS = (KMAX + 1) + (DAM ? KMAX : 0);
  uint64_t r[ROWS][W];

  __device__ __forceinline__ void reset(const uint64_t* s_init, int k) {
#pragma unroll
    for (int d = 0; d <= KMAX; ++d)
#pragma unroll
      for (int w = 0; w < W; ++w) r[d][w] = (d <= k) ? s_init[d * W + w] : 0ull;
#pragma unroll
    for (int d = KMAX + 1; d < ROWS; ++d)
#pragma unroll
      for (int w = 0; w < W; ++w) r[d][w] = 0ull;
  }

  // Advance one symbol; out[w] = OR over rows of (new & match) for limb w.
  __device__ __forceinline__ void step(const uint64_t* s_tbl, int sym,
                                       const uint64_t* st, const uint64_t* nl,
                                       const uint64_t* s_match, int k,
                                       uint64_t* out) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t bc = s_tbl[(sym & (MAX_A - 1)) * W + w];
      const uint64_t old0 = r[0][w];
      const uint64_t n0 = ((old0 << 1) | st[w]) & bc;
      r[0][w] = n0;
      uint64_t acc = n0 & s_match[w];
      uint64_t bcn = 0, sbc = 0;
      if constexpr (DAM) {
        bcn = (bc >> 1) & nl[w];
        sbc = bc << 1;
      }
      uint64_t prev_dm1 = old0, new_dm1 = n0;
#pragma unroll
      for (int d = 1; d <= KMAX; ++d) {
        if (d <= k) {
          const uint64_t old = r[d][w];
          uint64_t nd = ((old << 1) & bc) | ((prev_dm1 | new_dm1) << 1) |
                        prev_dm1 | st[w];
          if constexpr (DAM) {
            nd |= (r[KMAX + d][w] << 1) & sbc;
            r[KMAX + d][w] = ((prev_dm1 << 1) | st[w]) & bcn;
          }
          r[d][w] = nd;
          acc |= nd & s_match[d * W + w];
          prev_dm1 = old;
          new_dm1 = nd;
        }
      }
      out[w] = acc;
    }
  }
};

// Loads the tables shared by both kernels into shared memory / registers.
template <int W, int KMAX>
__device__ __forceinline__ void load_tables(const Tables& tb, int A, int k,
                                            uint64_t* s_tbl, uint64_t* s_match,
                                            uint64_t* s_init, uint64_t* st,
                                            uint64_t* nl, int tid, int nthreads) {
  for (int i = tid; i < A * W; i += nthreads) s_tbl[i] = tb.tbl[i];
  for (int i = A * W + tid; i < MAX_A * W; i += nthreads) s_tbl[i] = 0ull;
  for (int i = tid; i < (KMAX + 1) * W; i += nthreads) {
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

template <int W, int KMAX, bool DAM>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_flags_kernel(const uint8_t* __restrict__ ids, long long n, Tables tb,
                  int A, int k, int halo, uint8_t* __restrict__ flags) {
  __shared__ uint64_t s_tbl[MAX_A * W];
  __shared__ uint64_t s_match[(KMAX + 1) * W];
  __shared__ uint64_t s_init[(KMAX + 1) * W];
  __shared__ __align__(16) uint8_t s_ids[STAGE_BYTES];
  __shared__ uint32_t s_bits[BITS_WORDS];  // [chunk word j][thread]

  const int tid = threadIdx.x;
  const long long blk0 = (long long)blockIdx.x * BLOCK_SYMS;
  uint64_t st[W], nl[W];
  load_tables<W, KMAX>(tb, A, k, s_tbl, s_match, s_init, st, nl, tid,
                       SCAN_THREADS);

  // Stage stream bytes [blk0 - HALO_MAX, blk0 + BLOCK_SYMS): 16-byte units,
  // neighbouring threads on neighbouring units; out of range reads as 0.
  const long long g0 = blk0 - HALO_MAX;
  const bool aligned = (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  for (int r = tid * 16; r < STAGE_SYMS; r += SCAN_THREADS * 16) {
    const long long g = g0 + r;
    uint32_t v[4];
    if (aligned && g >= 0 && g + 16 <= n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(ids + g));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long gb = g + 4 * j + b;
          const uint32_t byte = (gb >= 0 && gb < n) ? ids[gb] : 0u;
          word |= byte << (8 * b);
        }
        v[j] = word;
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_ids + swz(r));
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = v[j];
  }
  __syncthreads();

  // This thread's chunk: block-relative positions [c0, c0 + SCAN_CHUNK),
  // warmed up from the fresh state over [c0 - halo, c0).
  const int c0 = tid * SCAN_CHUNK;
  if (blk0 + c0 < n) {
    Nfa<W, KMAX, DAM> nfa;
    nfa.reset(s_init, k);
    uint64_t out[W];
    for (int q = c0 - halo; q < c0; ++q) {
      nfa.step(s_tbl, s_ids[swz(q + HALO_MAX)], st, nl, s_match, k, out);
    }
#pragma unroll 1
    for (int j = 0; j < SCAN_CHUNK / 32; ++j) {
      uint32_t bits = 0;
#pragma unroll 1
      for (int b = 0; b < 32; b += 4) {
        const int q = c0 + j * 32 + b;
        const uint32_t four =
            *reinterpret_cast<const uint32_t*>(s_ids + swz(q + HALO_MAX));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          nfa.step(s_tbl, (four >> (8 * i)) & 0xFF, st, nl, s_match, k, out);
          uint64_t any = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) any |= out[w];
          bits |= (any != 0 ? 1u : 0u) << (b + i);
        }
      }
      s_bits[j * SCAN_THREADS + tid] = bits;
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < SCAN_CHUNK / 32; ++j) s_bits[j * SCAN_THREADS + tid] = 0u;
  }
  __syncthreads();

  // Write flags [blk0, blk0 + BLOCK_SYMS) as 16-byte units in stream order.
  for (int p = tid * 16; p < BLOCK_SYMS; p += SCAN_THREADS * 16) {
    const long long g = blk0 + p;
    if (g >= n) break;
    const int owner = p / SCAN_CHUNK;
    const int j = (p % SCAN_CHUNK) / 32;
    const uint32_t half = (s_bits[j * SCAN_THREADS + owner] >> (p % 32)) & 0xFFFFu;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = (half >> (4 * i)) & 0xFu;
      v[i] = (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
    }
    if (g + 16 <= n && (reinterpret_cast<uintptr_t>(flags + g) & 15) == 0) {
      *reinterpret_cast<uint4*>(flags + g) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int b = 0; b < 16 && g + b < n; ++b) {
        flags[g + b] = (uint8_t)((v[b >> 2] >> (8 * (b & 3))) & 0xFF);
      }
    }
  }
}

template <int W, int KMAX, bool DAM>
__global__ void __launch_bounds__(REPLAY_THREADS)
replay_words_kernel(const uint8_t* __restrict__ ids, long long n,
                    const long long* __restrict__ pos, long long nhits,
                    Tables tb, int A, int k, int halo,
                    long long* __restrict__ words) {
  __shared__ uint64_t s_tbl[MAX_A * W];
  __shared__ uint64_t s_match[(KMAX + 1) * W];
  __shared__ uint64_t s_init[(KMAX + 1) * W];
  uint64_t st[W], nl[W];
  load_tables<W, KMAX>(tb, A, k, s_tbl, s_match, s_init, st, nl, threadIdx.x,
                       REPLAY_THREADS);
  __syncthreads();

  const long long h = (long long)blockIdx.x * REPLAY_THREADS + threadIdx.x;
  if (h >= nhits) return;
  const long long p = pos[h];
  Nfa<W, KMAX, DAM> nfa;
  nfa.reset(s_init, k);
  uint64_t out[W];
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = 0ull;
  // Replay ids[p - halo + 1 .. p] from the fresh state; reads outside the
  // stream are the dead symbol 0.
  for (long long q = p - halo + 1; q <= p; ++q) {
    const int sym = (q >= 0 && q < n) ? ids[q] : 0;
    nfa.step(s_tbl, sym, st, nl, s_match, k, out);
  }
  long long* dst = words + h * (2 * W);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    dst[2 * w] = (long long)(out[w] & 0xFFFFFFFFull);
    dst[2 * w + 1] = (long long)(out[w] >> 32);
  }
}

// Variant of the row count: k == 0 exact; k <= 2 and k <= 6 with masking.
template <int W, int KMAX, bool DAM>
cudaError_t launch_variant(bool replay, const uint8_t* ids, long long n,
                           const long long* pos, long long nhits,
                           const Tables& tb, int A, int k, int halo, void* out,
                           cudaStream_t stream) {
  if (replay) {
    const long long blocks = (nhits + REPLAY_THREADS - 1) / REPLAY_THREADS;
    replay_words_kernel<W, KMAX, DAM><<<(unsigned)blocks, REPLAY_THREADS, 0, stream>>>(
        ids, n, pos, nhits, tb, A, k, halo, static_cast<long long*>(out));
  } else {
    const long long blocks = (n + BLOCK_SYMS - 1) / BLOCK_SYMS;
    scan_flags_kernel<W, KMAX, DAM><<<(unsigned)blocks, SCAN_THREADS, 0, stream>>>(
        ids, n, tb, A, k, halo, static_cast<uint8_t*>(out));
  }
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(bool replay, const uint8_t* ids, long long n,
                     const long long* pos, long long nhits, const Tables& tb,
                     int A, int k, int halo, void* out, cudaStream_t stream) {
  const bool dam = tb.notlast != nullptr && k >= 1;
  if (k == 0)
    return launch_variant<W, 0, false>(replay, ids, n, pos, nhits, tb, A, k, halo, out, stream);
  if (k <= 2)
    return dam ? launch_variant<W, 2, true>(replay, ids, n, pos, nhits, tb, A, k, halo, out, stream)
               : launch_variant<W, 2, false>(replay, ids, n, pos, nhits, tb, A, k, halo, out, stream);
  return dam ? launch_variant<W, MAX_K, true>(replay, ids, n, pos, nhits, tb, A, k, halo, out, stream)
             : launch_variant<W, MAX_K, false>(replay, ids, n, pos, nhits, tb, A, k, halo, out, stream);
}

cudaError_t dispatch(bool replay, const void* ids, long long n, const void* pos,
                     long long nhits, const void* tbl, const void* starts,
                     const void* match, const void* init, const void* notlast,
                     int A, int W, int k, int halo, void* out, void* stream) {
  if (A < 1 || A > MAX_A || W < 1 || W > MAX_W || k < 0 || k > MAX_K ||
      halo < 1 || halo > HALO_MAX ||
      n < 1 || (replay && nhits < 1)) {
    return cudaErrorInvalidValue;
  }
  const Tables tb{static_cast<const uint64_t*>(tbl), static_cast<const uint64_t*>(starts),
                  static_cast<const uint64_t*>(match), static_cast<const uint64_t*>(init),
                  static_cast<const uint64_t*>(notlast)};
  const uint8_t* u8 = static_cast<const uint8_t*>(ids);
  const long long* p = static_cast<const long long*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_w<1>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 2: return launch_w<2>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 3: return launch_w<3>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 4: return launch_w<4>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 5: return launch_w<5>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 6: return launch_w<6>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 7: return launch_w<7>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    case 8: return launch_w<8>(replay, u8, n, p, nhits, tb, A, k, halo, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ids: u8 [n]; flags: u8 [n]. Tables are u64 (see Tables). Returns the
// launch's cudaError_t (0 = launched).
int fac_scan_flags(const void* ids, long long n, const void* tbl,
                   const void* starts, const void* match, const void* init,
                   const void* notlast, int A, int W, int k, int halo,
                   void* flags, void* stream) {
  return (int)dispatch(false, ids, n, nullptr, 0, tbl, starts, match, init,
                       notlast, A, W, k, halo, flags, stream);
}

// pos: int64 [nhits] stream positions < n; words: int64 [nhits, 2W] holding
// the u32 halves (low, high) of each limb's match word.
int fac_replay_words(const void* ids, long long n, const void* pos,
                     long long nhits, const void* tbl, const void* starts,
                     const void* match, const void* init, const void* notlast,
                     int A, int W, int k, int halo, void* words, void* stream) {
  return (int)dispatch(true, ids, n, pos, nhits, tbl, starts, match, init,
                       notlast, A, W, k, halo, words, stream);
}

const char* fac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
