// Exclusive int32 scan of block counts for Hopper (sm_90a):
// block_offsets_kernel.
//
// Replaces the prefix sum of the JAX package's compaction
// (fuzzy_aho_corasick_tpu/ops/compact.py::cumsum_i32, compact_indices),
// which XLA ran as an MXU prefix sum. Plain torch version:
// ops/packed_bitap.py::block_offsets_torch; wrapper packed_bitap.block_offsets.
//
// What it computes. offsets[i] = counts[0] + ... + counts[i - 1] for
// 0 <= i <= len: offsets[0] = 0, offsets[len] the total. Every caller keeps
// its totals inside int32, and integer addition is exact, so any order of
// the sums gives the plain version's bits.
//
// What bounds it on the H100, and the design. A scan reads 4 bytes and
// writes 4 per count; the callers' arrays hold 10^2-10^6 counts, so below
// ~10^5 counts a call is bound by its launch (and the host's time to make
// it), above by bytes. So: one launch at every length, a single pass
// without a loop over tiles. Up to 16,384 counts one block of
// OFFSETS_THREADS threads takes them all, OFFSETS_ITEMS (16) a thread,
// loaded as four int4 (where the array is 16-byte aligned) and scanned in
// registers; then a warp scan of the thread totals (shuffles) and a block
// scan of the 32 warp totals (one warp) give each thread its offset. Past
// that the blocks take tiles of CHAIN_ITEMS (4) counts a thread, so a
// long array has more blocks than the card holds at once and one block's
// loads overlap another's stores, and the blocks
// chain by decoupled look-back (lookback.cuh, the protocol the typed
// expansion shares): a block takes its tile from a ticket, publishes the
// tile's total in a status word, then its first warp reads the words of the
// 32 tiles before it at once and adds their totals back to the nearest one
// that already published its inclusive prefix, and publishes its own. The
// words are epoch-tagged, so the caller's status array lives across calls
// and nothing is reset between them.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int OFFSETS_THREADS = 1024;
constexpr int OFFSETS_ITEMS = 16;  // counts per thread in one tile: four int4 loads
constexpr long long OFFSETS_TILE = (long long)OFFSETS_THREADS * OFFSETS_ITEMS;
// Counts per thread past one tile: smaller tiles, so more blocks than the
// card holds at once and one block's loads overlap another's stores.
constexpr int CHAIN_ITEMS = 4;
constexpr long long CHAIN_TILE = (long long)OFFSETS_THREADS * CHAIN_ITEMS;
constexpr int OFFSETS_WARPS = OFFSETS_THREADS / 32;
static_assert(OFFSETS_WARPS == 32, "the block scan scans the 32 warp totals in one warp");

// The ITEMS counts from ``at`` on (zeros past len).
template <int ITEMS>
__device__ __forceinline__ void load_counts(const int* __restrict__ counts, long long len,
                                            long long at, bool vec, int (&v)[ITEMS]) {
  if (vec && at + ITEMS <= len) {
    const int4* p = reinterpret_cast<const int4*>(counts + at);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) v[q] = at + q < len ? __ldg(counts + at + q) : 0;
  }
}

// The block of tile t scans it (OFFSETS_THREADS x ITEMS counts) and
// writes offsets[i] for i in the tile, the last tile's block offsets[len].
// ``status`` (null where there is one tile) is lookback.cuh's array.
template <int ITEMS>
__global__ void __launch_bounds__(OFFSETS_THREADS)
block_offsets_kernel(const int* __restrict__ counts, long long len, bool vec,
                     unsigned long long* status, unsigned epoch, unsigned long long base,
                     int* __restrict__ offsets) {
  __shared__ int s_scan[OFFSETS_WARPS];
  __shared__ int s_carry;
  __shared__ long long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = status == nullptr ? 0 : lookback::take_tile(status, base, &s_tile);
  const long long at = t * ITEMS * OFFSETS_THREADS + (long long)tid * ITEMS;
  int v[ITEMS];
  load_counts<ITEMS>(counts, len, at, vec, v);
  // Exclusive prefix of the thread's counts, in registers.
  int total = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int c = v[q];
    v[q] = total;
    total += c;
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += up;
    }
    s_scan[lane] = w;  // inclusive over the warps
    const int tile_total = __shfl_sync(0xFFFFFFFFu, w, 31);
    int carry = 0;
    if (status != nullptr) {
      if (t > 0) {
        if (lane == 0) lookback::publish(status, epoch, t, false, tile_total);
        carry = lookback::look_back<32>(status, epoch, t, nullptr, nullptr);
      }
      if (lane == 0) lookback::publish(status, epoch, t, true, carry + tile_total);
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  const int carry = s_carry;
  const int before = carry + (warp > 0 ? s_scan[warp - 1] : 0) + incl - total;
  if (at + ITEMS <= len) {
    // offsets is the wrapper's own allocation: 16-byte aligned, and ``at``
    // is a multiple of 4.
    int4* p = reinterpret_cast<int4*>(offsets + at);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q)
      p[q] = make_int4(before + v[4 * q], before + v[4 * q + 1], before + v[4 * q + 2],
                       before + v[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (at + q < len) offsets[at + q] = before + v[q];
  }
  if (t == gridDim.x - 1 && tid == OFFSETS_THREADS - 1)
    offsets[len] = carry + s_scan[OFFSETS_WARPS - 1];
}

}  // namespace

extern "C" {

// Counts one block of the scan takes: up to it one block scans them all;
// past it the blocks take fac_offsets_chain_tile() counts each, and the
// caller hands lookback.cuh's status array for ceil(len / chain tile) tiles.
int fac_offsets_tile() { return (int)OFFSETS_TILE; }
int fac_offsets_chain_tile() { return (int)CHAIN_TILE; }

// counts: int32 [len]; offsets: int32 [len + 1], 16-byte aligned. Where len
// passes one tile (else unused): status: uint64 [>= 1 + ceil(len /
// fac_offsets_chain_tile())], lookback.cuh's array, zeroed when made and
// never reset; epoch: 1..2^32 - 1, a value no earlier call on this array
// used; base: its ticket counter's value when this call starts. Returns the
// launch's cudaError_t (0 = launched).
int fac_block_offsets(const void* counts, long long len, void* offsets, void* status,
                      long long epoch, long long base, void* stream) {
  const bool chain = len > OFFSETS_TILE;
  const long long tiles = chain ? (len + CHAIN_TILE - 1) / CHAIN_TILE : 1;
  if (len < 1 || tiles > 0x7FFFFFFFll ||
      (chain && (status == nullptr || epoch < 1 || epoch > 0xFFFFFFFFll || base < 0)) ||
      reinterpret_cast<uintptr_t>(offsets) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  int* out = static_cast<int*>(offsets);
  if (chain) {
    block_offsets_kernel<CHAIN_ITEMS><<<(unsigned)tiles, OFFSETS_THREADS, 0, s>>>(
        c, len, vec, static_cast<unsigned long long*>(status), (unsigned)epoch,
        (unsigned long long)base, out);
  } else {
    block_offsets_kernel<OFFSETS_ITEMS><<<1, OFFSETS_THREADS, 0, s>>>(c, len, vec, nullptr, 0, 0,
                                                                      out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
