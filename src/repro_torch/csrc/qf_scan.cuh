// The probe scan of a sorted quotient stream, one pass across the card.
//
// pos[i] = i + max(c, cummax_{j <= i} d[j]), d[j] = fq[j] - j for a valid
// row (j < n) and -INT32_MAX from row n on: the closed form of the linear
// probe pos[i] = max(pos[i - 1] + 1, fq[i]), with c = last_pos + 1 carrying
// it across appended spans (INT_MIN, no carry, for a whole build).  The
// JAX package runs this scan as lax.cummax, XLA code around its Pallas
// build (repro/kernels/ops.py::_build_sorted and ::_span_math).
//
// What bounds it on the H100: bytes, one read of the stream's valid rows.  Blocks run
// in no order, so a max carried across tiles needs either a second pass
// over the stream or a look-back; this is the decoupled look-back, one
// pass.  A block takes its tile from an atomic ticket, so every tile
// before it is already resident, reduces its 8192 rows, publishes that
// aggregate, then reads its predecessors' status words 32 at a time (one
// warp) back to the nearest one that holds an inclusive prefix, and
// publishes its own.  A status word is one 64-bit store: the value in the
// low half, a flag and the launch's epoch in the high half, so a word left
// by an earlier launch reads as not yet written and no launch clears the
// scratch.  The last block to finish re-arms the ticket and counter and
// advances the epoch for the next launch on the stream.
//
// The look-back costs time per tile, so tiles are large: 8192 rows ran
// faster on the H100 than 4096 or 16384, and reading 128 status words a
// round trip in place of 32, or a fence before the count of finished
// blocks, only added time.  Occupancy counts too: only the 32 d values of a
// lane stay live across the look-back (a valid row's quotient is d + i), so
// four blocks fit an SM.
//
// A warp scans its 1024 rows in 32 rounds of 32: coalesced loads (all in
// flight before the first use), a 5-step shuffle scan of int32 values per
// round, the running max carried in a register, and each row's predecessor
// quotient from a shuffle (one load a warp for the first row).  The d values
// are int32: valid quotients lie in [0, INT32_MAX] and rows below 2**31.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_ROUNDS = 32;                       // rows a lane scans
constexpr int SCAN_WARP_ROWS = 32 * SCAN_ROUNDS;       // 1024
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ROUNDS;  // 8192 rows a block
constexpr int32_t SCAN_PAST_N = -INT32_MAX;            // d of a row at or past n

// Scratch, zeroed once when allocated: uint32 ticket, done count, epoch and
// a pad word, then one 64-bit status word a tile.
constexpr unsigned SCAN_AGGREGATE = 1, SCAN_PREFIX = 2;

__device__ __forceinline__ unsigned long long scan_word(unsigned epoch,
                                                        unsigned flag,
                                                        int32_t v) {
  unsigned tag = ((epoch & 0x3fffffffu) << 2) | flag;
  return ((unsigned long long)tag << 32) | (uint32_t)v;
}

// The flag of a status word written in this launch's epoch; 0 otherwise.
__device__ __forceinline__ unsigned scan_flag(unsigned long long w,
                                              unsigned epoch) {
  unsigned tag = (unsigned)(w >> 32);
  return (tag >> 2) == (epoch & 0x3fffffffu) ? (tag & 3u) : 0u;
}

// Scan one tile, calling emit(i, q, prev_q, pos, valid) for each row
// i < n_items the block owns: pos the int64 position, and for a valid row
// q = (int32)fq[i] and prev_q that of row i - 1 (first_prev for row 0).  Every thread of the
// block must call it once, and every block of the grid.
template <typename T, typename Emit>
__device__ __forceinline__ void scan_tile(const T* __restrict__ fq,
                                          long long n_items, long long n_valid,
                                          int32_t carry, int32_t first_prev,
                                          uint32_t* hdr,
                                          unsigned long long* status,
                                          Emit&& emit) {
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;
  __shared__ int32_t s_warp[SCAN_WARPS];
  __shared__ int32_t s_excl;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(hdr, 1u);
    s_epoch = *(volatile uint32_t*)(hdr + 2);
  }
  __syncthreads();
  const long long tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long base = tile * SCAN_TILE + (long long)warp * SCAN_WARP_ROWS;

  // rows past n are not read
  int32_t d[SCAN_ROUNDS];
#pragma unroll
  for (int r = 0; r < SCAN_ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    d[r] = i < n_valid ? (int32_t)((uint32_t)(int32_t)fq[i] - (uint32_t)i) : SCAN_PAST_N;
  }
  int32_t m = INT_MIN;
#pragma unroll
  for (int r = 0; r < SCAN_ROUNDS; ++r) m = max(m, d[r]);
  m = __reduce_max_sync(full, m);
  if (lane == 0) s_warp[warp] = m;
  __syncthreads();

  if (warp == 0) {  // publish the tile, then look back for its prefix
    volatile unsigned long long* vs = status;
    const int32_t agg =
        __reduce_max_sync(full, lane < SCAN_WARPS ? s_warp[lane] : INT_MIN);
    int32_t excl = INT_MIN;
    if (tile == 0) {
      if (lane == 0) vs[0] = scan_word(epoch, SCAN_PREFIX, agg);
    } else {
      if (lane == 0) vs[tile] = scan_word(epoch, SCAN_AGGREGATE, agg);
      for (long long last = tile - 1;; last -= 32) {
        const long long j = last - lane;  // lane 0 reads the nearest tile
        unsigned flag = SCAN_PREFIX;      // before tile 0: nothing to add
        int32_t v = INT_MIN;
        if (j >= 0) {
          unsigned long long w = vs[j];
          while ((flag = scan_flag(w, epoch)) == 0) {
            __nanosleep(32);
            w = vs[j];
          }
          v = (int32_t)(uint32_t)w;
        }
        const unsigned pre = __ballot_sync(full, flag == SCAN_PREFIX);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        excl = max(excl, __reduce_max_sync(full, lane <= stop ? v : INT_MIN));
        if (pre) break;
      }
      if (lane == 0) vs[tile] = scan_word(epoch, SCAN_PREFIX, max(excl, agg));
    }
    if (lane == 0) {
      s_excl = excl;
      // every block took its ticket and read the epoch before counting
      // itself done, so the last one may re-arm them for the next launch
      if (atomicAdd(hdr + 1, 1u) == gridDim.x - 1) {
        volatile uint32_t* vh = hdr;
        vh[0] = 0;
        vh[1] = 0;
        vh[2] = epoch + 1;
      }
    }
  }
  __syncthreads();

  int32_t run = s_excl;  // the max of every row before this warp's
  for (int w = 0; w < warp; ++w) run = max(run, s_warp[w]);
  if (base >= n_items) return;
  // the quotient before the warp's first row, needed only if that row is valid
  int32_t before = base > 0 && base <= n_valid ? (int32_t)fq[base - 1] : first_prev;
#pragma unroll
  for (int r = 0; r < SCAN_ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    const int32_t q = (int32_t)((uint32_t)d[r] + (uint32_t)i);  // of a valid row
    int32_t x = d[r];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(full, x, o);
      if (lane >= o) x = max(x, y);
    }
    x = max(x, run);
    const int32_t up = __shfl_up_sync(full, q, 1);
    const int32_t prev = lane == 0 ? before : up;
    before = __shfl_sync(full, q, 31);
    run = __shfl_sync(full, x, 31);
    if (i < n_items) emit(i, q, prev, i + (long long)max(carry, x), i < n_valid);
  }
}
