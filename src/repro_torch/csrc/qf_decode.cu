// Decode the slot planes of a quotient filter into its sorted fingerprints.
//
// Replaces no TPU kernel: the JAX package decodes with XLA code
// (repro/core/quotient_filter.py::extract: three cumsums, a searchsorted
// and two scatters), and the port's plain version is the same arithmetic
// (core/quotient_filter.py::decode_planes).  Slot s is nonempty when
// occ[s] | shf[s]; a run starts at a nonempty slot that is not a
// continuation; run_id[s] counts the run starts up to and including s, and
// the slot's quotient is the position of the run_id-th set occ bit (0 when
// run_id is 0, total when fewer buckets are occupied).  A nonempty slot
// writes (quotient, rem read as uint32), both int64, to the row of its rank
// among the nonempty slots; every other row holds (INT32_MAX, UINT32_MAX).
// Any planes decode, well formed or not, exactly as the plain version does.
//
// What bounds it on the H100: bytes.  It must read 7 plane bytes a slot
// and write 16 stream bytes a slot.  The plain version makes three passes
// of int32 and int64 temporaries over the table and a binary search of a
// slot-long cumsum per slot.  Here two launches stream the planes once:
//
// - The index pass reads occ, shf and con in tiles of 8192 slots, a lane 32
//   consecutive slots as two 16-byte loads a plane turned into bit words.
//   A decoupled look-back (qf_scan.cuh's status words, one for each count,
//   in a scratch zeroed for the launch) carries three counts across tiles:
//   occupied buckets, runs started and nonempty slots.  It writes the
//   positions of the occupied buckets in order (int32, staged in shared
//   memory so that the stores are whole), the runs started and nonempty
//   slots before each 1024-slot chunk, a lane's nonempty and run-start
//   bits as two words, and the two totals.
// - The write pass gives each chunk one warp, 32 rounds of 32 slots with
//   lane i on slot i, so it needs no look-back: a round's masks come from
//   the bit words, a run's quotient from the compacted positions (read
//   almost in order), and the nonempty lanes of a round store to
//   consecutive rows, so the int64 stores are whole.  The warp then writes
//   the padding of the rows in its chunk's range at or past the count.
//
// Scratch beyond the bound: 4 bytes written and read again an occupied
// bucket, and the bit words (0.25 bytes a slot each way).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "qf_scan.cuh"

constexpr int DECODE_THREADS = 256;
constexpr int DECODE_WARPS = DECODE_THREADS / 32;
constexpr int DECODE_LANE_SLOTS = 32;                            // a bit word
constexpr int DECODE_CHUNK = 32 * DECODE_LANE_SLOTS;             // 1024 slots a warp
constexpr int DECODE_TILE = DECODE_THREADS * DECODE_LANE_SLOTS;  // 8192 slots a block
constexpr int DECODE_COUNTS = 3;  // occupied buckets, runs started, nonempty slots
constexpr unsigned DECODE_EPOCH = 0;  // the scratch is zeroed for each launch

// Bit k set where p[base + k] is nonzero, for the slots below total.  p is
// 16-byte aligned and base a multiple of 32.
__device__ __forceinline__ uint32_t plane_bits(const uint8_t* __restrict__ p,
                                               long long base,
                                               long long total) {
  uint32_t bits = 0;
  if (base + DECODE_LANE_SLOTS <= total) {
    const uint4* v = reinterpret_cast<const uint4*>(p + base);
    const uint4 a = v[0], b = v[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)  // four bytes' 0/1 to four bits in one multiply
      bits |= ((__vsetne4(w[k], 0u) * 0x01020408u) >> 24) << (4 * k);
  } else {
    for (int k = 0; base + k < total; ++k)
      bits |= (uint32_t)(p[base + k] != 0) << k;
  }
  return bits;
}

// The scratch the index pass leaves for the write pass.
struct DecodeWork {
  int32_t* buckets;     // the occupied buckets' positions, in order
  int32_t* chunk_runs;  // runs started before each chunk
  int32_t* chunk_rows;  // nonempty slots before each chunk
  uint32_t* ne_bits;    // each bit word's nonempty slots
  uint32_t* rs_bits;    // each bit word's run starts
  int32_t* totals;      // occupied buckets, nonempty slots
};

__global__ void __launch_bounds__(DECODE_THREADS)
    qf_decode_index_kernel(const uint8_t* __restrict__ occ,
                           const uint8_t* __restrict__ shf,
                           const uint8_t* __restrict__ con, long long total,
                           uint32_t* ticket, unsigned long long* status,
                           DecodeWork work) {
  __shared__ int s_tile;
  __shared__ int32_t s_warp[DECODE_COUNTS][DECODE_WARPS];
  __shared__ int32_t s_excl[DECODE_COUNTS], s_agg[DECODE_COUNTS];
  __shared__ int32_t s_pos[DECODE_TILE];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // tiles in the order blocks start, so every tile before this one is
  // resident or done, and a look-back never waits on a block not yet started
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long word = tile * DECODE_THREADS + threadIdx.x;
  const long long base = word * DECODE_LANE_SLOTS;

  const uint32_t o = plane_bits(occ, base, total);
  const uint32_t ne = o | plane_bits(shf, base, total);  // continuation implies shifted
  const uint32_t rs = ne & ~plane_bits(con, base, total);
  const int32_t own[DECODE_COUNTS] = {__popc(o), __popc(rs), __popc(ne)};
  int32_t incl[DECODE_COUNTS];
#pragma unroll
  for (int c = 0; c < DECODE_COUNTS; ++c) {
    int32_t x = own[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(full, x, d);
      if (lane >= d) x += y;
    }
    incl[c] = x;
    if (lane == 31) s_warp[c][warp] = x;
  }
  __syncthreads();

  if (warp == 0) {  // publish the tile's counts, then look back for its prefix
    volatile unsigned long long* vs = status;
    int32_t agg[DECODE_COUNTS], excl[DECODE_COUNTS] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < DECODE_COUNTS; ++c)
      agg[c] = __reduce_add_sync(full, lane < DECODE_WARPS ? s_warp[c][lane] : 0);
    if (tile > 0) {
      if (lane == 0)
        for (int c = 0; c < DECODE_COUNTS; ++c)
          vs[DECODE_COUNTS * tile + c] = scan_word(DECODE_EPOCH, SCAN_AGGREGATE, agg[c]);
      // Each count stops at its own nearest prefix: the three words of a
      // tile are stored one after another, so they may differ in flag.
      unsigned open = (1u << DECODE_COUNTS) - 1;
      for (long long last = tile - 1; open; last -= 32) {
        const long long j = last - lane;  // lane 0 reads the nearest tile
#pragma unroll
        for (int c = 0; c < DECODE_COUNTS; ++c) {
          if (!((open >> c) & 1u)) continue;
          unsigned flag = SCAN_PREFIX;  // before tile 0: nothing to add
          int32_t v = 0;
          if (j >= 0) {
            unsigned long long w = vs[DECODE_COUNTS * j + c];
            while ((flag = scan_flag(w, DECODE_EPOCH)) == 0) {
              __nanosleep(32);
              w = vs[DECODE_COUNTS * j + c];
            }
            v = (int32_t)(uint32_t)w;
          }
          const unsigned pre = __ballot_sync(full, flag == SCAN_PREFIX);
          const int stop = pre ? __ffs(pre) - 1 : 31;
          excl[c] += __reduce_add_sync(full, lane <= stop ? v : 0);
          if (pre) open &= ~(1u << c);
        }
      }
    }
    if (lane == 0) {
      for (int c = 0; c < DECODE_COUNTS; ++c) {
        vs[DECODE_COUNTS * tile + c] = scan_word(DECODE_EPOCH, SCAN_PREFIX, excl[c] + agg[c]);
        s_excl[c] = excl[c];
        s_agg[c] = agg[c];
      }
    }
  }
  __syncthreads();

  int32_t before[DECODE_COUNTS];  // the counts over every slot before the lane's
#pragma unroll
  for (int c = 0; c < DECODE_COUNTS; ++c) {
    int32_t v = s_excl[c] + incl[c] - own[c];
    for (int w = 0; w < warp; ++w) v += s_warp[c][w];
    before[c] = v;
  }
  int32_t at = before[0] - s_excl[0];  // the lane's first place in the tile's list
  for (uint32_t m = o; m; m &= m - 1) s_pos[at++] = (int32_t)(base + __ffs(m) - 1);
  if (base < total) {
    work.ne_bits[word] = ne;
    work.rs_bits[word] = rs;
    if (lane == 0) {  // the warp's slots are one chunk
      work.chunk_runs[word / 32] = before[1];
      work.chunk_rows[word / 32] = before[2];
    }
  }
  __syncthreads();
  int32_t* out = work.buckets + s_excl[0];
  for (int i = threadIdx.x; i < s_agg[0]; i += DECODE_THREADS) out[i] = s_pos[i];
  if (tile == gridDim.x - 1 && threadIdx.x == 0) {
    work.totals[0] = s_excl[0] + s_agg[0];
    work.totals[1] = s_excl[2] + s_agg[2];
  }
}

constexpr int WRITE_BATCH = 8;  // rounds whose loads are in flight together

__global__ void __launch_bounds__(DECODE_THREADS)
    qf_decode_write_kernel(const int32_t* __restrict__ rem, long long total,
                           DecodeWork work, long long* __restrict__ fq,
                           long long* __restrict__ fr) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * DECODE_WARPS + (threadIdx.x >> 5);
  const long long base = chunk * DECODE_CHUNK;
  if (base >= total) return;
  const int32_t* __restrict__ buckets = work.buckets;
  const int32_t occupied = work.totals[0], rows = work.totals[1];
  const long long word = chunk * 32 + lane;  // round r's bits are lane r's word
  const bool has = word * DECODE_LANE_SLOTS < total;
  const uint32_t my_ne = has ? work.ne_bits[word] : 0u;
  const uint32_t my_rs = has ? work.rs_bits[word] : 0u;
  int32_t run = work.chunk_runs[chunk];  // runs started before the round
  int32_t row = work.chunk_rows[chunk];  // nonempty slots before the round
  const uint32_t below = (1u << lane) - 1u, upto = below | (1u << lane);
  for (int r0 = 0; r0 < 32; r0 += WRITE_BATCH) {
    bool live[WRITE_BATCH];
    int32_t rv[WRITE_BATCH];
    long long qv[WRITE_BATCH], dest[WRITE_BATCH];
#pragma unroll
    for (int k = 0; k < WRITE_BATCH; ++k) {
      const uint32_t ne = __shfl_sync(full, my_ne, r0 + k);
      const uint32_t rs = __shfl_sync(full, my_rs, r0 + k);
      const int32_t id = run + __popc(rs & upto);
      live[k] = (ne >> lane) & 1u;
      dest[k] = row + __popc(ne & below);
      rv[k] = live[k] ? __ldg(rem + base + (r0 + k) * 32 + lane) : 0;
      qv[k] = !live[k] || id == 0 ? 0
              : id <= occupied    ? (long long)__ldg(buckets + id - 1)
                                  : total;
      run += __popc(rs);
      row += __popc(ne);
    }
#pragma unroll
    for (int k = 0; k < WRITE_BATCH; ++k) {
      if (live[k]) {
        fq[dest[k]] = qv[k];
        fr[dest[k]] = (long long)(uint32_t)rv[k];
      }
    }
  }
  const long long end = min(base + DECODE_CHUNK, total);
  for (long long i = max(base, (long long)rows) + lane; i < end; i += 32) {
    fq[i] = INT32_MAX;
    fr[i] = UINT32_MAX;
  }
}

// Writes fq and fr, int64 (total,).  rem is int32, occ/shf/con bytes read
// as bool, all (total,); the three byte planes must be 16-byte aligned.
// scratch is the look-back's, zeroed: a 64-bit word whose low half is the
// tile ticket, then three status words a tile (1 + 3 * tiles words).  The
// work arrays, written before they are read:
// buckets int32 (total,), chunk_runs and chunk_rows int32 (chunks,),
// ne_bits and rs_bits (words,) and totals (2,), where a chunk is
// DECODE_CHUNK slots and a word DECODE_LANE_SLOTS.  Returns
// cudaGetLastError(), or cudaErrorMisalignedAddress.
extern "C" int qf_decode(const void* rem, const void* occ, const void* shf,
                         const void* con, long long total, void* scratch,
                         void* buckets, void* chunk_runs, void* chunk_rows,
                         void* ne_bits, void* rs_bits, void* totals, void* fq,
                         void* fr, void* stream) {
  if (((uintptr_t)occ | (uintptr_t)shf | (uintptr_t)con) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (total <= 0) return (int)cudaGetLastError();
  const DecodeWork w = {(int32_t*)buckets, (int32_t*)chunk_runs,
                        (int32_t*)chunk_rows, (uint32_t*)ne_bits,
                        (uint32_t*)rs_bits, (int32_t*)totals};
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (total + DECODE_TILE - 1) / DECODE_TILE;
  qf_decode_index_kernel<<<(unsigned)tiles, DECODE_THREADS, 0, s>>>(
      (const uint8_t*)occ, (const uint8_t*)shf, (const uint8_t*)con, total,
      (uint32_t*)scratch, (unsigned long long*)scratch + 1, w);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long chunks = (total + DECODE_CHUNK - 1) / DECODE_CHUNK;
  qf_decode_write_kernel<<<(unsigned)((chunks + DECODE_WARPS - 1) / DECODE_WARPS),
                           DECODE_THREADS, 0, s>>>((const int32_t*)rem, total, w,
                                                   (long long*)fq, (long long*)fr);
  return (int)cudaGetLastError();
}
