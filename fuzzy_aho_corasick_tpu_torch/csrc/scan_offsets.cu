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
// chain by decoupled look-back: block t publishes its tile's total in a
// status word, then its first warp reads the words of the 32 tiles before
// it at once and adds their totals back to the nearest one that already
// published its inclusive prefix, and publishes its own. A status word is
// (epoch << 32 | prefix flag << 31 | value): the caller hands a status
// array that lives across calls and a new epoch per call, so words of an
// earlier call read as not yet published and nothing is reset between
// calls. Blocks are dispatched in index order, so the tiles a block waits
// for are running or done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OFFSETS_THREADS = 1024;
constexpr int OFFSETS_ITEMS = 16;  // counts per thread in one tile: four int4 loads
constexpr long long OFFSETS_TILE = (long long)OFFSETS_THREADS * OFFSETS_ITEMS;
// Counts per thread past one tile: smaller tiles, so more blocks than the
// card holds at once and one block's loads overlap another's stores.
constexpr int CHAIN_ITEMS = 4;
constexpr long long CHAIN_TILE = (long long)OFFSETS_THREADS * CHAIN_ITEMS;
constexpr int OFFSETS_WARPS = OFFSETS_THREADS / 32;
constexpr unsigned long long PREFIX = 1ull << 31;  // the word holds an inclusive prefix
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

// The totals of the tiles before tile t (> 0), whose own total is
// ``total``, read by the 32 lanes of one warp from the status words, and
// published: first the tile's total, then its inclusive prefix.
__device__ __forceinline__ int look_back(volatile unsigned long long* status, unsigned epoch,
                                         long long t, int total, int lane) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  if (lane == 0) status[t] = tag | (unsigned)total;
  int carry = 0;
  for (long long top = t - 1;; top -= 32) {
    const long long idx = top - lane;
    unsigned long long w = tag | PREFIX;  // before tile 0: an empty prefix
    if (idx >= 0) {
      do {
        w = status[idx];
      } while ((unsigned)(w >> 32) != epoch);
    }
    // Lane 0 reads the nearest tile: the lanes up to the first one holding
    // a prefix add up to everything before tile t.
    const unsigned pre = __ballot_sync(0xFFFFFFFFu, (w & PREFIX) != 0);
    const int first = pre != 0 ? __ffs(pre) - 1 : 31;
    int part = lane <= first ? (int)(w & (PREFIX - 1)) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xFFFFFFFFu, part, o);
    carry += part;
    if (pre != 0) break;
  }
  if (lane == 0) status[t] = tag | PREFIX | (unsigned)(carry + total);
  return carry;
}

// Block t scans tile t (OFFSETS_THREADS x ITEMS counts) and writes
// offsets[i] for i in the tile, the last block offsets[len]. ``status``
// (null where there is one tile) holds a word per tile.
template <int ITEMS>
__global__ void __launch_bounds__(OFFSETS_THREADS)
block_offsets_kernel(const int* __restrict__ counts, long long len, bool vec,
                     unsigned long long* status, unsigned epoch, int* __restrict__ offsets) {
  __shared__ int s_scan[OFFSETS_WARPS];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = blockIdx.x;
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
      if (t == 0) {
        if (lane == 0) {
          reinterpret_cast<volatile unsigned long long*>(status)[0] =
              ((unsigned long long)epoch << 32) | PREFIX | (unsigned)tile_total;
        }
      } else {
        carry = look_back(status, epoch, t, tile_total, lane);
      }
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
  if (blockIdx.x == gridDim.x - 1 && tid == OFFSETS_THREADS - 1)
    offsets[len] = carry + s_scan[OFFSETS_WARPS - 1];
}

}  // namespace

extern "C" {

// Counts one block of the scan takes: up to it one block scans them all;
// past it the blocks take fac_offsets_chain_tile() counts each, and the
// caller hands a status array of at least ceil(len / chain tile) words.
int fac_offsets_tile() { return (int)OFFSETS_TILE; }
int fac_offsets_chain_tile() { return (int)CHAIN_TILE; }

// counts: int32 [len]; offsets: int32 [len + 1], 16-byte aligned; status:
// uint64 [>= ceil(len / fac_offsets_chain_tile())] where len passes one tile (else
// unused), zeroed when made and never reset; epoch: 1..2^32 - 1, a value no
// earlier call on this status array used. Returns the launch's cudaError_t (0 =
// launched).
int fac_block_offsets(const void* counts, long long len, void* offsets, void* status,
                      long long epoch, void* stream) {
  const bool chain = len > OFFSETS_TILE;
  const long long tiles = chain ? (len + CHAIN_TILE - 1) / CHAIN_TILE : 1;
  if (len < 1 || tiles > 0x7FFFFFFFll ||
      (chain && (status == nullptr || epoch < 1 || epoch > 0xFFFFFFFFll)) ||
      reinterpret_cast<uintptr_t>(offsets) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  int* out = static_cast<int*>(offsets);
  if (chain) {
    block_offsets_kernel<CHAIN_ITEMS><<<(unsigned)tiles, OFFSETS_THREADS, 0, s>>>(
        c, len, vec, static_cast<unsigned long long*>(status), (unsigned)epoch, out);
  } else {
    block_offsets_kernel<OFFSETS_ITEMS><<<1, OFFSETS_THREADS, 0, s>>>(c, len, vec, nullptr, 0,
                                                                      out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
