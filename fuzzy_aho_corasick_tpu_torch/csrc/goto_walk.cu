// The goto walk for Hopper (sm_90a): goto_walk_count_kernel and
// goto_walk_emit_kernel, behind and around block_offsets_kernel.
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/exact.py::_exact_scan_rows (+ _rows_of,
// :45-161): the exact search of the dictionaries the packed shift-AND scan
// does not take (more than 128 symbol classes, a field past 64 graphemes,
// more than 64 limbs), the seed filter's exact pass on such a seed engine,
// and the sharded exact lane's per-shard walk. Plain torch version:
// ops/exact.py::goto_walk_torch; wrapper ops/exact.py::goto_walk.
//
// What it computes. Every start s < n_starts walks the goto table (int32
// [N, C], -1 = no edge; the caller folds the prune mask in as -1) from the
// root: span 1 reaches goto[0][ids[s]], span t + 1 goto[node][ids[s + t]].
// A walk ends where the node is -1, at span L, or where its next symbol
// would lie at or past n_read (a shard reads a halo past the starts it
// owns). Every arrival at a node whose emits flag is set is one output
// (start, span, node), int64 [3, H], ordered by start, then span. The
// tally (int64 [L + 1]) gets the arrivals in [0] and the walks alive after
// span t in [t] (the JAX package's survivors_stage1 and _stage2 are the
// first two).
//
// The pass, two launches around block_offsets_kernel (scan_offsets.cu) and
// one host read:
//   count: block b takes the starts [b T, (b + 1) T), T = WALK_TILE, walks
//          each, and writes its arrivals into counts[b]; it adds them and
//          its walks alive at each span into the tally, one atomic per
//          block and span;
//   block_offsets: offsets[b] = the arrivals of the blocks before b;
//   the host reads the tally (the only wait) and allocates [3, H];
//   emit:  a block with arrivals walks its starts again, in rounds of
//          WALK_THREADS starts, and writes each arrival at offsets[b] plus
//          the arrivals of the block's earlier starts (a block scan of the
//          per-thread counts of the round: warp shuffles, then one warp
//          over the warp totals). A block without arrivals returns at once.
// Walking again costs less than keeping the survivors: a survivor list
// would cost device memory per survivor and a compaction of its own, and
// only the blocks with arrivals walk again. Most walks are short but do
// not end at once: on exact1k (1,000 words, 7,093 x 30 table) 86 % of the
// starts survive their first symbol, 49 % their second and 3 % their
// third.
//
// What bounds it on the H100. The device memory it must move: the symbols
// read once, the goto table and the emits flags once, 24 bytes per
// arrival written, about one byte per start for u8 symbols. Per start one
// root-row lookup; per step of a surviving walk one symbol and one goto
// entry, a data-dependent gather that exact1k's table (851 KB) serves from
// L2. The design: the block's symbols (its tile and the L - 1 after it,
// up to WALK_HALO_MAX) and, for C <= ROOT_SMEM, the goto table's root row
// are staged in shared memory, so the first step reads no device memory
// beyond the tile's coalesced load; goto entries come through the
// read-only path (__ldg); each walk is one thread's serial pointer chase,
// whose latency the block's other threads and the SM's other blocks hide.
// The alive counts sum in shared memory per block, one shared atomic per
// step of a walk (on exact1k 34.6 M, most on the first two spans' two
// addresses). Counting them per warp first, staging a whole goto table
// that fits and sharing long walks across a warp are not done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int WALK_ROUNDS = 8;
// Starts per block: WALK_ROUNDS rounds of one start per thread.
constexpr int WALK_TILE = WALK_THREADS * WALK_ROUNDS;
// Symbols past the tile staged in shared memory; a walk past them reads
// device memory.
constexpr int WALK_HALO_MAX = 1024;
// Root-row entries staged in shared memory (C <= 256: at most 1 KiB).
constexpr int ROOT_SMEM = 256;
// Spans whose alive counts sum in shared memory; deeper ones add straight
// into the tally.
constexpr int ALIVE_SMEM = 256;

struct WalkArgs {
  long long n_starts, n_read;
  const int32_t* go;      // [N, C]
  const uint8_t* emits;   // [N]
  int C, L;
};

// The block's symbols: [base, base + staged) in shared memory, the rest
// read from device memory.
template <typename SymT>
struct Tile {
  const SymT* ids;
  const SymT* s_sym;
  long long base;
  long long staged;

  __device__ __forceinline__ int at(long long p) const {
    const long long off = p - base;
    return off < staged ? (int)s_sym[off] : (int)__ldg(ids + p);
  }
};

// Stages block ``base``'s symbols and (C <= ROOT_SMEM) the root row; the
// caller synchronises.
template <typename SymT>
__device__ __forceinline__ Tile<SymT> stage(const SymT* __restrict__ ids, const WalkArgs& a,
                                            long long base, SymT* s_sym, int* s_root) {
  const long long end = min(base + WALK_TILE + min(a.L - 1, WALK_HALO_MAX), a.n_read);
  for (long long i = threadIdx.x; i < end - base; i += WALK_THREADS) s_sym[i] = ids[base + i];
  if (a.C <= ROOT_SMEM) {
    for (int c = threadIdx.x; c < a.C; c += WALK_THREADS) s_root[c] = __ldg(a.go + c);
  }
  return Tile<SymT>{ids, s_sym, base, end - base};
}

// The walk of start ``s``: visit(span, node) at every node it reaches,
// span ascending.
template <typename SymT, typename Visit>
__device__ __forceinline__ void walk(const Tile<SymT>& t, const WalkArgs& a, const int* s_root,
                                     long long s, Visit&& visit) {
  const int sym0 = t.at(s);
  int node = a.C <= ROOT_SMEM ? s_root[sym0] : __ldg(a.go + sym0);
  for (int span = 1; node >= 0; ++span) {
    visit(span, node);
    if (span == a.L || s + span >= a.n_read) break;
    node = __ldg(a.go + (long long)node * a.C + t.at(s + span));
  }
}

// Rounds of block ``base`` that hold starts (the same for every thread).
__device__ __forceinline__ int rounds_of(long long base, long long n_starts) {
  return (int)min((long long)WALK_ROUNDS, (n_starts - base + WALK_THREADS - 1) / WALK_THREADS);
}

template <typename SymT>
__global__ void __launch_bounds__(WALK_THREADS)
goto_walk_count_kernel(const SymT* __restrict__ ids, WalkArgs a, int* __restrict__ counts,
                       unsigned long long* __restrict__ tally) {
  __shared__ SymT s_sym[WALK_TILE + WALK_HALO_MAX];
  __shared__ int s_root[ROOT_SMEM];
  __shared__ int s_alive[ALIVE_SMEM];
  __shared__ int s_warp[WALK_WARPS];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * WALK_TILE;
  for (int i = tid; i < ALIVE_SMEM; i += WALK_THREADS) s_alive[i] = 0;
  const Tile<SymT> t = stage(ids, a, base, s_sym, s_root);
  __syncthreads();
  int hits = 0;
  const int rounds = rounds_of(base, a.n_starts);
  for (int r = 0; r < rounds; ++r) {
    const long long s = base + (long long)r * WALK_THREADS + tid;
    if (s >= a.n_starts) break;
    walk(t, a, s_root, s, [&](int span, int node) {
      if (span <= ALIVE_SMEM) {
        atomicAdd(&s_alive[span - 1], 1);
      } else {
        atomicAdd(&tally[span], 1ull);
      }
      hits += __ldg(a.emits + node);
    });
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_xor_sync(0xFFFFFFFFu, hits, o);
  if ((tid & 31) == 0) s_warp[tid >> 5] = hits;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WALK_WARPS; ++w) total += s_warp[w];
    counts[blockIdx.x] = total;
    if (total != 0) atomicAdd(&tally[0], (unsigned long long)total);
  }
  const int spans = min(a.L, ALIVE_SMEM);
  for (int i = tid; i < spans; i += WALK_THREADS) {
    if (s_alive[i] != 0) atomicAdd(&tally[i + 1], (unsigned long long)s_alive[i]);
  }
}

template <typename SymT>
__global__ void __launch_bounds__(WALK_THREADS)
goto_walk_emit_kernel(const SymT* __restrict__ ids, WalkArgs a, const int* __restrict__ offsets,
                      long long total, long long* __restrict__ found) {
  __shared__ SymT s_sym[WALK_TILE + WALK_HALO_MAX];
  __shared__ int s_root[ROOT_SMEM];
  __shared__ int s_scan[WALK_WARPS];
  long long at = offsets[blockIdx.x];
  if (offsets[blockIdx.x + 1] == at) return;  // no arrival in this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * WALK_TILE;
  const Tile<SymT> t = stage(ids, a, base, s_sym, s_root);
  __syncthreads();
  const int rounds = rounds_of(base, a.n_starts);
  for (int r = 0; r < rounds; ++r) {
    const long long s = base + (long long)r * WALK_THREADS + tid;
    int c = 0;
    if (s < a.n_starts) {
      walk(t, a, s_root, s, [&](int, int node) { c += __ldg(a.emits + node); });
    }
    // The round's exclusive scan of c, in thread (= start) order.
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < WALK_WARPS ? s_scan[lane] : 0;
#pragma unroll
      for (int o = 1; o < WALK_WARPS; o <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, w, o);
        if (lane >= o) w += up;
      }
      if (lane < WALK_WARPS) s_scan[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    if (c != 0) {
      long long k = at + (warp > 0 ? s_scan[warp - 1] : 0) + incl - c;
      walk(t, a, s_root, s, [&](int span, int node) {
        if (__ldg(a.emits + node) && k < total) {
          found[k] = s;
          found[total + k] = span;
          found[2 * total + k] = node;
          ++k;
        }
      });
    }
    at += s_scan[WALK_WARPS - 1];
    __syncthreads();  // s_scan is rewritten by the next round
  }
}

template <typename SymT>
int launch(const void* ids, const WalkArgs& a, int write, void* counts, void* tally,
           const void* offsets, long long total, void* found, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n_starts + WALK_TILE - 1) / WALK_TILE);
  const SymT* sym = static_cast<const SymT*>(ids);
  if (write == 0) {
    goto_walk_count_kernel<SymT><<<blocks, WALK_THREADS, 0, s>>>(
        sym, a, static_cast<int*>(counts), static_cast<unsigned long long*>(tally));
  } else {
    goto_walk_emit_kernel<SymT><<<blocks, WALK_THREADS, 0, s>>>(
        sym, a, static_cast<const int*>(offsets), total, static_cast<long long*>(found));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Starts one block walks: the count pass writes ceil(n_starts / tile)
// counts.
int fac_goto_walk_tile() { return WALK_TILE; }

// ids: u8 (sym_bytes 1) or int32 (sym_bytes 4) [>= n_read], symbols < C;
// 1 <= n_starts <= n_read < 2^31; go: int32 [N, C]; emits: u8 [N]; L >= 1.
// write == 0: counts int32 [ceil(n_starts / tile)] written, tally int64
// [L + 1] (zeroed by the caller) added to. write == 1: offsets int32
// [blocks + 1] (block_offsets of the counts) read, found int64 [3, total]
// written. Returns the launch's cudaError_t (0 = launched).
int fac_goto_walk(const void* ids, int sym_bytes, long long n_starts, long long n_read,
                  const void* go, int C, const void* emits, int L, int write, void* counts,
                  void* tally, const void* offsets, long long total, void* found,
                  void* stream) {
  if (n_starts < 1 || n_read < n_starts || n_read >= (1ll << 31) || C < 1 || L < 1 ||
      (sym_bytes != 1 && sym_bytes != 4) || ids == nullptr || go == nullptr ||
      emits == nullptr || (write == 0 && (counts == nullptr || tally == nullptr)) ||
      (write != 0 && (offsets == nullptr || found == nullptr || total < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const WalkArgs a{n_starts, n_read, static_cast<const int32_t*>(go),
                   static_cast<const uint8_t*>(emits), C, L};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sym_bytes == 1
             ? launch<uint8_t>(ids, a, write, counts, tally, offsets, total, found, s)
             : launch<int32_t>(ids, a, write, counts, tally, offsets, total, found, s);
}

}  // extern "C"
