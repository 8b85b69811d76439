// The goto walk for Hopper (sm_90a): goto_walk_count_kernel and
// goto_walk_emit_kernel, behind and around block_offsets_kernel.
//
// Replaces the JAX package's XLA device function
// fuzzy_aho_corasick_tpu/ops/exact.py::_exact_scan_rows (+ _rows_of,
// :45-161): the exact search of the dictionaries the packed shift-AND scan
// does not take (more than 128 symbol classes, a field past 64 graphemes,
// more than 64 limbs), the seed filter's exact pass on such a seed engine,
// and the sharded exact lane's per-shard walk. Plain torch version:
// ops/exact.py::goto_walk_torch; wrapper ops/exact.py::goto_walk; the
// folded table it reads: ops/exact.py::fold_table.
//
// What it computes. Every start s < n_starts walks the goto table (N nodes
// x C classes, -1 = no edge; the caller folds the prune mask in as -1) from
// the root: span 1 reaches goto[0][ids[s]], span t + 1 goto[node][ids[s + t]].
// A walk ends where the node is -1, at span L, or where its next symbol
// would lie at or past n_read (a shard reads a halo past the starts it
// owns). Every arrival at a node whose emits flag is set is one output
// (start, span, node), int64 [3, H], ordered by start, then span. The
// tally (int64 [L + 2]) gets the arrivals in [0], the walks alive after
// span t in [t] (the JAX package's survivors_stage1 and _stage2 are the
// first two) and the tiles past WALK_KEEP arrivals in [L + 1].
//
// The table the kernels read is folded (fold_table, built once per table):
// an entry is 2 * target + emits[target], -1 for no edge, so one lookup per
// step gives the next node and whether it emits. Where C <= PAIR_MAX, C
// rows follow the N rows of the table: row c0 is the folded row of the
// root's child by c0 (-1 where it has none), so span 2 is one lookup by
// (ids[s], ids[s + 1]) beside span 1's, not a gather behind it.
//
// The pass, two launches around block_offsets_kernel (scan_offsets.cu) and
// one host read:
//   count: persistent blocks (as many as the SMs hold) take the tiles of
//          WALK_TILE starts in turn. A block stages the root row and the
//          pair table once, and each tile's symbols (16 bytes a load) with
//          the L - 1 after it. With u8 symbols and the pair table a thread
//          takes four consecutive starts: the loads of their spans 1-3 first
//          (two shared lookups and one gather each), then the counts. A
//          walk past span 3 goes on a block-wide list, which the block
//          finishes once it may not hold another tile's (on exact1k: once,
//          at its end), a thread a walk, reading its symbols from device
//          memory. Otherwise a thread walks one start at a time. Arrivals
//          count per tile (counts[tile], added to by the listed walks) and
//          the first WALK_KEEP of a tile, (start, span, node), go into its
//          slots; at its end a block adds its tiles' arrivals to the tally
//          and puts the tiles past WALK_KEEP on the overflow list. The walks
//          alive at spans 1-4 count in registers and sum once per block
//          (one global add per block and span); deeper spans add into
//          shared memory (rare: on exact1k 3,999 walks pass span 4).
//   block_offsets: offsets[tile] = the arrivals of the tiles before it;
//   the host reads the tally (the only wait), allocates [3, H] and
//          launches the write pass with one thread per tile in its first
//          ceil(tiles / WALK_THREADS) blocks and one block per overflowing
//          tile after them;
//   emit:  a thread copies its tile's kept rows to offsets[tile], ranked by
//          (start, span) (the slots fill in no fixed order); a block of an
//          overflowing tile walks it again, in rounds of WALK_THREADS
//          starts, and writes each arrival at offsets[tile] plus the
//          arrivals of the tile's earlier starts (a block scan of the
//          per-thread counts of the round).
// WALK_KEEP = 16: exact1k has 3,997 arrivals over 12,288 tiles, at most 4
// in a tile, so no tile there walks again; the seed filters' CJK walks
// (about 2.4 arrivals a tile) walk their few tiles of 17-41 again. A run
// of 5,000 a's against patterns of 300 and 1,100 a's overflows every tile
// it touches.
//
// What bounds it on the H100. The device memory it must move: the symbols
// read once (one byte a start for u8 ids), the table once, 24 bytes per
// arrival written: 0.0078 ms at exact1k's shape. It is an integer pointer
// chase; tensor cores have no part in it. What the card measured instead
// (PERF.md §6; tools/walk_variants.py, count pass ms on exact1k):
// latency. Each span step costs about the same (0.013-0.027 ms) however
// few lanes take it: 86 % of exact1k's starts survive their first symbol,
// 49 % their second, 3 % their third. Against the first kernel pair's four
// costs:
//   1. one shared atomic per step for the alive counts: 7 % of its count
//      pass (0.1562 without, 0.1676 with); now registers per thread for
//      spans 1-4, one global add per block and span;
//   2. two dependent gathers per step (node, then its emits flag): 3 %
//      (0.1633 without); now one, the flag folded into the entry, and
//      spans 1-2 two independent shared lookups (without the pair table
//      0.1402 vs 0.0974);
//   3. a write pass that walked every tile with an arrival again: 0.0562;
//      now a copy of the kept rows, 0.0028;
//   4. lanes and blocks idle behind the longest walk: the loads of four
//      starts go out together (the generic walk 0.1462 vs 0.1002) and the
//      walks past span 3 wait for the block's end (per tile 0.1079).
// Tried and dropped (same-call pairs): the first rows renumbered
// breadth-first and staged as int16 (0.1141 vs 0.1149 unstaged), blocks of
// 512 threads (0.1197 vs 0.0974), one block per tile (0.1140 vs 0.1002),
// spans 1-4 in straight-line code, 8 blocks an SM (0.1053 vs 0.1050),
// tiles of 4,096 starts (0.0995 vs 0.1050, noise), an L1-first carveout
// (0.2873 vs 0.1046), one shared atomic a thread for the list (0.1007).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK_WARPS = WALK_THREADS / 32;
// Starts per tile.
constexpr int WALK_TILE = 2048;
// Symbols past the tile staged in shared memory; a walk past them reads
// device memory.
constexpr int WALK_HALO_MAX = 1024;
// Root-row entries staged in shared memory (C <= 256: at most 1 KiB).
constexpr int ROOT_SMEM = 256;
// Classes up to which the pair table (C x C) is staged: at most 16 KiB.
constexpr int PAIR_MAX = 64;
// Walks past span 3 a block lists (start, entry) to finish together once the
// list may not hold another tile's.
constexpr int DEEP_MAX = 3072;
// Spans whose alive counts sum in shared memory; deeper ones add straight
// into the tally. Spans 1-4 count in registers.
constexpr int ALIVE_SMEM = 256;
// Arrivals a tile keeps for the write pass; a tile with more walks again.
constexpr int WALK_KEEP = 16;

struct WalkArgs {
  long long n_starts, n_read;
  const int32_t* go;  // folded [N (+ C), C]
  int N, C, L, tiles;
};

__host__ __device__ __forceinline__ bool has_pair(int C) { return C <= PAIR_MAX; }
__host__ __device__ __forceinline__ bool has_root(int C) { return C <= ROOT_SMEM; }
// Dynamic shared memory of both passes: the root row and the pair table.
size_t table_smem(int C) {
  return sizeof(int) * (has_pair(C) ? C + C * C : has_root(C) ? C : 0);
}

// A tile's symbols: [0, staged) from its base in shared memory, the rest
// from device memory; lim: the symbols readable from its base (n_read).
template <typename SymT>
struct Tile {
  const SymT* ids;  // ids + base
  const SymT* s_sym;
  int staged, lim;

  __device__ __forceinline__ int at(int off) const {
    return off < staged ? (int)s_sym[off] : (int)__ldg(ids + off);
  }
};

// Stages the tile at ``base`` (16 bytes a load where the symbols are so
// aligned); the caller synchronises.
template <typename SymT>
__device__ __forceinline__ Tile<SymT> stage(const SymT* __restrict__ ids, const WalkArgs& a,
                                            long long base, SymT* s_sym) {
  const int lim = (int)(a.n_read - base);
  const int staged = min(WALK_TILE + min(a.L - 1, WALK_HALO_MAX), lim);
  const SymT* src = ids + base;
  constexpr int PER = 16 / sizeof(SymT);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = staged / PER;
    for (int i = threadIdx.x; i < vecs; i += WALK_THREADS) {
      reinterpret_cast<uint4*>(s_sym)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
    done = vecs * PER;
  }
  for (int i = done + threadIdx.x; i < staged; i += WALK_THREADS) s_sym[i] = src[i];
  return Tile<SymT>{src, s_sym, staged, lim};
}

// The root row (C <= ROOT_SMEM) and the pair table (C <= PAIR_MAX) into
// s_tab, once per block; the caller synchronises.
__device__ __forceinline__ void stage_tables(const WalkArgs& a, int* s_tab) {
  if (has_root(a.C)) {
    for (int c = threadIdx.x; c < a.C; c += WALK_THREADS) s_tab[c] = __ldg(a.go + c);
  }
  if (has_pair(a.C)) {
    const int32_t* pair = a.go + (long long)a.N * a.C;
    for (int i = threadIdx.x; i < a.C * a.C; i += WALK_THREADS) s_tab[a.C + i] = __ldg(pair + i);
  }
}

// The folded entry of node ``e >> 1`` (e a folded entry) at class ``c``.
__device__ __forceinline__ int next(const WalkArgs& a, int e, int c) {
  return __ldg(a.go + (unsigned)((e >> 1) * a.C + c));
}

// Spans the walk of the tile's start ``off`` may take: at most L, none
// reading at or past n_read.
template <typename SymT>
__device__ __forceinline__ int spans_of(const Tile<SymT>& t, const WalkArgs& a, int off) {
  return min(a.L, t.lim - off);
}

// The walk of the tile's start ``off`` from span ``span`` on, entry ``e``
// reached at it: visit(span, e) at every entry e >= 0, span ascending.
template <typename SymT, typename Visit>
__device__ __forceinline__ void walk_on(const Tile<SymT>& t, const WalkArgs& a, int off,
                                        int span, int e, Visit&& visit) {
  const int last = spans_of(t, a, off);
  while (e >= 0) {
    visit(span, e);
    if (++span > last) return;
    e = next(a, e, t.at(off + span - 1));
  }
}

// The whole walk of the tile's start ``off``.
template <typename SymT, typename Visit>
__device__ __forceinline__ void walk(const Tile<SymT>& t, const WalkArgs& a, const int* s_tab,
                                     int off, Visit&& visit) {
  const int c0 = t.s_sym[off];
  walk_on(t, a, off, 1, has_root(a.C) ? s_tab[c0] : __ldg(a.go + c0), visit);
}

template <typename SymT>
__global__ void __launch_bounds__(WALK_THREADS)
goto_walk_count_kernel(const SymT* __restrict__ ids, WalkArgs a, int* __restrict__ counts,
                       int4* __restrict__ keep, int* __restrict__ overflow,
                       unsigned long long* __restrict__ tally) {
  __shared__ __align__(16) SymT s_sym[WALK_TILE + WALK_HALO_MAX];
  __shared__ int2 s_deep[DEEP_MAX];  // walks past span 3: (start, entry)
  __shared__ int s_alive[ALIVE_SMEM];
  __shared__ int s_red[WALK_WARPS][4];
  __shared__ int s_hits, s_ndeep;
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x;
  for (int i = tid; i < ALIVE_SMEM; i += WALK_THREADS) s_alive[i] = 0;
  if (tid == 0) s_hits = s_ndeep = 0;
  stage_tables(a, s_tab);
  int a1 = 0, a2 = 0, a3 = 0, a4 = 0;  // walks alive after spans 1-4
  const auto alive = [&](int span) {
    if (span == 1) {
      ++a1;
    } else if (span == 2) {
      ++a2;
    } else if (span == 3) {
      ++a3;
    } else if (span == 4) {
      ++a4;
    } else if (span <= ALIVE_SMEM) {
      atomicAdd(&s_alive[span - 1], 1);
    } else {
      atomicAdd(&tally[span], 1ull);
    }
  };
  // An arrival of the tile's start ``off``: counted in counts[tile] (which
  // holds the tile's arrivals so far once the tile is walked), kept in its
  // slots while they last.
  const auto keep_row = [&](int tile, int j, int off, int span, int e) {
    if (j < WALK_KEEP) keep[(long long)tile * WALK_KEEP + j] = make_int4(off, span, e >> 1, 0);
  };
  // The listed walks, a thread each, reading their symbols from device
  // memory; the caller synchronises before.
  const auto finish_deep = [&]() {
    const int listed = s_ndeep;
    for (int k = tid; k < listed; k += WALK_THREADS) {
      const int2 d = s_deep[k];
      const int tile = d.x / WALK_TILE, off = d.x - tile * WALK_TILE;
      const long long base = (long long)tile * WALK_TILE;
      const Tile<SymT> g{ids + base, s_sym, 0, (int)(a.n_read - base)};
      walk_on(g, a, off, 4, next(a, d.y, g.at(off + 3)), [&](int span, int e) {
        alive(span);
        if (e & 1) keep_row(tile, atomicAdd(&counts[tile], 1), off, span, e);
      });
    }
    __syncthreads();
    if (tid == 0) s_ndeep = 0;
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long base = (long long)tile * WALK_TILE;
    __syncthreads();  // the last tile is done with s_sym; s_hits reset
    if (s_ndeep > DEEP_MAX - WALK_TILE) finish_deep();
    const Tile<SymT> t = stage(ids, a, base, s_sym);
    __syncthreads();
    const auto visit = [&](int off) {
      return [&, off](int span, int e) {
        alive(span);
        if (e & 1) keep_row(tile, atomicAdd(&s_hits, 1), off, span, e);
      };
    };
    const int n = (int)min((long long)WALK_TILE, a.n_starts - base);
    if (sizeof(SymT) == 1 && has_pair(a.C)) {
      // Four consecutive starts a thread, their symbols from two 32-bit
      // words. Spans 1-3 in straight-line, predicated code, the loads of
      // the four starts first so that their latencies overlap: spans 1 and
      // 2 are two independent lookups of the root row and the pair table,
      // span 3 the first gather. Then the counts; arrivals branch off, and
      // a walk past span 3 (3 % of exact1k's) is listed and finished with
      // the block's others, so that no warp and no tile waits on one
      // lane's long walk.
      const uint32_t* s_word = reinterpret_cast<const uint32_t*>(s_sym);
      for (int q = tid; 4 * q < n; q += WALK_THREADS) {
        const unsigned long long w =
            s_word[q] | (unsigned long long)s_word[q + 1] << 32;
        int last[4], e1[4], e2[4], e3[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = 4 * q + j;
          last[j] = off < n ? spans_of(t, a, off) : 0;
          const int c0 = last[j] >= 1 ? (int)(w >> (8 * j)) & 0xFF : 0;
          const int c1 = last[j] >= 2 ? (int)(w >> (8 * j + 8)) & 0xFF : 0;
          e1[j] = s_tab[c0];
          e2[j] = s_tab[a.C + c0 * a.C + c1];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok2 = last[j] >= 3 && e1[j] >= 0 && e2[j] >= 0;
          e3[j] = ok2 ? next(a, e2[j], (int)(w >> (8 * j + 16)) & 0xFF) : -1;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = 4 * q + j;
          const bool ok1 = last[j] >= 1 && e1[j] >= 0;
          const bool ok2 = ok1 && last[j] >= 2 && e2[j] >= 0;
          const bool ok3 = e3[j] >= 0;
          a1 += ok1;
          a2 += ok2;
          a3 += ok3;
          if ((ok1 && (e1[j] & 1)) || (ok2 && (e2[j] & 1)) || (ok3 && (e3[j] & 1))) {
            if (e1[j] & 1) keep_row(tile, atomicAdd(&s_hits, 1), off, 1, e1[j]);  // ok1 holds
            if (ok2 && (e2[j] & 1)) keep_row(tile, atomicAdd(&s_hits, 1), off, 2, e2[j]);
            if (ok3 && (e3[j] & 1)) keep_row(tile, atomicAdd(&s_hits, 1), off, 3, e3[j]);
          }
          if (ok3 && last[j] >= 4) {
            s_deep[atomicAdd(&s_ndeep, 1)] = make_int2((int)base + off, e3[j]);
          }
        }
      }
    } else {
      for (int off = tid; off < n; off += WALK_THREADS) walk(t, a, s_tab, off, visit(off));
    }
    __syncthreads();
    if (tid == 0) {
      atomicExch(&counts[tile], s_hits);  // where the listed walks add on
      s_hits = 0;
    }
  }
  __syncthreads();
  finish_deep();
  // The block's tiles, now counted in full: the arrivals into the tally,
  // the tiles past WALK_KEEP into the overflow list.
  unsigned long long hits = 0;
  for (int tile = blockIdx.x + tid * gridDim.x; tile < a.tiles;
       tile += WALK_THREADS * gridDim.x) {
    const int h = __ldcg(counts + tile);
    hits += h;
    if (h > WALK_KEEP) overflow[atomicAdd(&tally[a.L + 1], 1ull)] = tile;
  }
  if (hits != 0) atomicAdd(&tally[0], hits);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xFFFFFFFFu, a1, o);
    a2 += __shfl_xor_sync(0xFFFFFFFFu, a2, o);
    a3 += __shfl_xor_sync(0xFFFFFFFFu, a3, o);
    a4 += __shfl_xor_sync(0xFFFFFFFFu, a4, o);
  }
  if ((tid & 31) == 0) {
    s_red[tid >> 5][0] = a1;
    s_red[tid >> 5][1] = a2;
    s_red[tid >> 5][2] = a3;
    s_red[tid >> 5][3] = a4;
  }
  __syncthreads();
  if (tid < 4 && tid < a.L) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WALK_WARPS; ++w) sum += s_red[w][tid];
    if (sum != 0) atomicAdd(&tally[tid + 1], (unsigned long long)sum);
  }
  const int spans = min(a.L, ALIVE_SMEM);
  for (int i = 4 + tid; i < spans; i += WALK_THREADS) {
    if (s_alive[i] != 0) atomicAdd(&tally[i + 1], (unsigned long long)s_alive[i]);
  }
}

__device__ __forceinline__ void write_row(long long* found, long long total, long long k,
                                          long long start, int span, int node) {
  found[k] = start;
  found[total + k] = span;
  found[2 * total + k] = node;
}

template <typename SymT>
__global__ void __launch_bounds__(WALK_THREADS)
goto_walk_emit_kernel(const SymT* __restrict__ ids, WalkArgs a, const int* __restrict__ offsets,
                      const int4* __restrict__ keep, const int* __restrict__ overflow,
                      int copy_blocks, long long total, long long* __restrict__ found) {
  __shared__ __align__(16) SymT s_sym[WALK_TILE + WALK_HALO_MAX];
  __shared__ int s_scan[WALK_WARPS];
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x < copy_blocks) {
    // One thread per tile: its kept rows, ranked by (start, span).
    const int tile = blockIdx.x * WALK_THREADS + tid;
    if (tile >= a.tiles) return;
    const int at = offsets[tile], n = offsets[tile + 1] - at;
    if (n == 0 || n > WALK_KEEP) return;
    const int4* slot = keep + (long long)tile * WALK_KEEP;
    const long long base = (long long)tile * WALK_TILE;
    for (int i = 0; i < n; ++i) {
      const int4 ki = slot[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const int4 kj = slot[j];
        rank += kj.x < ki.x || (kj.x == ki.x && kj.y < ki.y);
      }
      write_row(found, total, at + rank, base + ki.x, ki.y, ki.z);
    }
    return;
  }
  // A tile past WALK_KEEP arrivals: walk it again.
  const int tile = overflow[blockIdx.x - copy_blocks];
  const long long base = (long long)tile * WALK_TILE;
  long long at = offsets[tile];
  stage_tables(a, s_tab);
  const Tile<SymT> t = stage(ids, a, base, s_sym);
  __syncthreads();
  const int n = (int)min((long long)WALK_TILE, a.n_starts - base);
  for (int r = 0; r * WALK_THREADS < n; ++r) {
    const int off = r * WALK_THREADS + tid;
    int c = 0;
    if (off < n) walk(t, a, s_tab, off, [&](int, int e) { c += e & 1; });
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
      walk(t, a, s_tab, off, [&](int span, int e) {
        if ((e & 1) && k < total) write_row(found, total, k++, base + off, span, e >> 1);
      });
    }
    at += s_scan[WALK_WARPS - 1];
    __syncthreads();  // s_scan is rewritten by the next round
  }
}

// Blocks of ``kernel`` the current card holds at once (SMs x blocks per
// SM at ``smem`` bytes of dynamic shared memory); 0 on an error.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WALK_THREADS, smem) !=
          cudaSuccess) {
    return 0;
  }
  return sms * per_sm;
}

template <typename SymT>
int launch(const void* ids, const WalkArgs& a, int write, void* counts, void* keep,
           void* overflow, void* tally, const void* offsets, long long total, int n_over,
           void* found, cudaStream_t s) {
  const SymT* sym = static_cast<const SymT*>(ids);
  const size_t smem = table_smem(a.C);
  if (write == 0) {
    // Persistent blocks: as many as the card holds, looping over the tiles.
    const int held = resident_blocks(goto_walk_count_kernel<SymT>, smem);
    if (held < 1) return (int)cudaErrorLaunchOutOfResources;
    goto_walk_count_kernel<SymT><<<min(a.tiles, held), WALK_THREADS, smem, s>>>(
        sym, a, static_cast<int*>(counts), static_cast<int4*>(keep), static_cast<int*>(overflow),
        static_cast<unsigned long long*>(tally));
  } else {
    const int copy_blocks = (a.tiles + WALK_THREADS - 1) / WALK_THREADS;
    goto_walk_emit_kernel<SymT><<<copy_blocks + n_over, WALK_THREADS, smem, s>>>(
        sym, a, static_cast<const int*>(offsets), static_cast<const int4*>(keep),
        static_cast<const int*>(overflow), copy_blocks, total, static_cast<long long*>(found));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Starts one tile holds: the count pass writes ceil(n_starts / tile)
// counts.
int fac_goto_walk_tile() { return WALK_TILE; }
// Arrivals a tile keeps for the write pass (int32 [4] each).
int fac_goto_walk_keep() { return WALK_KEEP; }
// Classes up to which the folded table carries the pair table's C rows.
int fac_goto_walk_pair_max() { return PAIR_MAX; }

// ids: u8 (sym_bytes 1) or int32 (sym_bytes 4) [>= n_read], symbols < C;
// 1 <= n_starts <= n_read < 2^31; go: the folded table (fold_table), int32
// [rows, C], rows = N + C where C <= PAIR_MAX, else N; L >= 1. tiles =
// ceil(n_starts / tile). write == 0: counts int32 [tiles], keep int32
// [tiles, keep, 4] (16-byte aligned) and overflow int32 [tiles] written,
// tally int64 [L + 2] (zeroed by the caller) added to. write == 1: offsets
// int32 [tiles + 1] (block_offsets of the counts), keep and overflow read,
// n_over = tally[L + 1], found int64 [3, total] written. Returns the
// launch's cudaError_t (0 = launched).
int fac_goto_walk(const void* ids, int sym_bytes, long long n_starts, long long n_read,
                  const void* go, int N, int C, int L, int write, void* counts, void* keep,
                  void* overflow, void* tally, const void* offsets, long long total, int n_over,
                  void* found, void* stream) {
  const long long tiles = (n_starts + WALK_TILE - 1) / WALK_TILE;
  if (n_starts < 1 || n_read < n_starts || n_read >= (1ll << 31) || C < 1 || L < 1 || N < 1 ||
      (long long)(N + (has_pair(C) ? C : 0)) * C >= (1ll << 31) || 2ll * N + 1 >= (1ll << 31) ||
      (sym_bytes != 1 && sym_bytes != 4) || ids == nullptr || go == nullptr ||
      keep == nullptr || overflow == nullptr || (reinterpret_cast<uintptr_t>(keep) & 15) != 0 ||
      (write == 0 && (counts == nullptr || tally == nullptr)) ||
      (write != 0 && (offsets == nullptr || found == nullptr || total < 1 || n_over < 0 ||
                      n_over > tiles))) {
    return (int)cudaErrorInvalidValue;
  }
  const WalkArgs a{n_starts, n_read, static_cast<const int32_t*>(go), N, C, L, (int)tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sym_bytes == 1
             ? launch<uint8_t>(ids, a, write, counts, keep, overflow, tally, offsets, total,
                               n_over, found, s)
             : launch<int32_t>(ids, a, write, counts, keep, overflow, tally, offsets, total,
                               n_over, found, s);
}

}  // extern "C"
