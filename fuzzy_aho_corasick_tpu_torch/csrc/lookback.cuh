// Decoupled look-back across the blocks of one launch, for Hopper (sm_90a):
// the one protocol of scan_offsets.cu's block_offsets_kernel (the chained
// scan past one tile) and dp_typed.cu's typed_expand_kernel (the one-pass
// expansion).
//
// The status array. It lives across calls on one stream (the host keeps
// one per device and stream, zeroed when made): word 0 is a ticket
// counter, word 1 + t the status of tile t. A call hands it an epoch that
// no earlier call on the array used, and base, the counter's value when
// the call starts (the host adds up the blocks of the calls before it).
//   - Tickets. A block takes its tile t = atomicAdd(counter) - base, not
//     blockIdx.x, so every tile it waits on belongs to a block that took
//     its ticket earlier and runs or has run: forward progress without
//     assuming that blocks are dispatched in index order.
//   - Status words, (epoch << 32 | PREFIX | value): tile t publishes its
//     own total (PREFIX clear), then its inclusive prefix (PREFIX set);
//     release stores, acquire loads. A word of an earlier call carries
//     another epoch and reads as not yet published, so nothing is cleared
//     between calls: no memset, no launch of its own.
//   - Values are non-negative int32 below 2^31 (the callers' totals fit).
// A tile t > 0 reads the words of the THREADS tiles before it at once, one
// a thread, and adds them back to the nearest one that holds an inclusive
// prefix, further back in turns of THREADS where none does.

#pragma once

#include <cstdint>
#include <cuda/atomic>

namespace lookback {

constexpr unsigned long long PREFIX = 1ull << 31;  // the word holds an inclusive prefix
constexpr unsigned long long VALUE = PREFIX - 1;

// The calling block's tile: threads 0..blockDim-1 all call it, and get the
// ticket thread 0 took (``s_tile`` is the block's shared slot for it).
__device__ __forceinline__ long long take_tile(unsigned long long* status,
                                               unsigned long long base, long long* s_tile) {
  if (threadIdx.x == 0) *s_tile = (long long)(atomicAdd(status, 1ull) - base);
  __syncthreads();
  return *s_tile;
}

// Tile t's word: its total, or with ``prefix`` its inclusive prefix.
__device__ __forceinline__ void publish(unsigned long long* status, unsigned epoch, long long t,
                                        bool prefix, int value) {
  const unsigned long long w =
      (unsigned long long)epoch << 32 | (prefix ? PREFIX : 0ull) | (unsigned)value;
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(status[1 + t])
      .store(w, cuda::memory_order_release);
}

// The sum of the tiles before tile t (> 0). Threads 0..THREADS-1 of the
// block call it together: one warp (THREADS = 32, no barrier) or the whole
// block (a multiple of 32, with ``s_first`` and ``s_part`` of THREADS / 32
// ints each in shared memory; every thread gets the sum). The caller
// published tile t's total.
template <int THREADS>
__device__ __forceinline__ int look_back(unsigned long long* status, unsigned epoch, long long t,
                                         int* s_first, int* s_part) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps of one block");
  constexpr int WARPS = THREADS / 32;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  int carry = 0;
  for (long long top = t - 1;; top -= THREADS) {
    const long long idx = top - i;
    unsigned long long w = tag | PREFIX;  // before tile 0: an empty prefix
    if (idx >= 0) {
      cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> word(status[1 + idx]);
      do {
        w = word.load(cuda::memory_order_acquire);
      } while ((w & ~0xFFFFFFFFull) != tag);
    }
    // Thread 0 reads the nearest tile: the threads up to the first one
    // holding a prefix add up to everything between it and tile t.
    const unsigned pre = __ballot_sync(0xFFFFFFFFu, (w & PREFIX) != 0);
    int first = pre != 0 ? warp * 32 + __ffs(pre) - 1 : THREADS;
    if constexpr (WARPS > 1) {
      if (lane == 0) s_first[warp] = first;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < WARPS; ++k) first = min(first, s_first[k]);
    }
    int part = i <= first ? (int)(w & VALUE) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xFFFFFFFFu, part, o);
    if constexpr (WARPS > 1) {
      if (lane == 0) s_part[warp] = part;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < WARPS; ++k) carry += s_part[k];
      __syncthreads();  // s_first and s_part are written again
    } else {
      carry += part;
    }
    if (first < THREADS) return carry;
  }
}

}  // namespace lookback
