// Bulk quotient-filter build: write the slot planes of sorted fingerprints.
//
// Replaces the TPU kernel repro/kernels/qf_build.py::qf_build_planes.  Like
// the TPU kernel, it writes one tile of TILE slots per program, and finds a
// tile's items by a search: probe positions strictly increase, so the
// items that land in a tile are one contiguous range.  The one-hot
// reduction the TPU needed becomes a scatter into shared memory.
//
// What bounds it on the H100: bytes.  It must write 7 bytes per slot and
// read 12 per item.  Zero-filling the planes first and then scattering
// items into them writes most plane sectors twice, the second time as
// partial sectors the 50 MB L2 has long evicted.  Here a block builds its
// tile in shared memory (zeros, then its items' values) and stores each
// plane's tile once, 16 bytes a thread, so every plane byte is written
// once and nothing is zeroed beforehand.
//
// A block finds its ranges by four searches, one warp each: the items whose
// position lies in the tile (rem/shf/con) and those whose quotient does
// (occ, which is set for an in-range quotient even when its item's position
// fell off the end).  Each search is 32-way: a warp tests 32 points at once,
// so 12.6 M items take 5 dependent rounds.  n_valid is read on the card.
//
// Two more entries share the probe scan of qf_scan.cuh (lax.cummax in the
// JAX package, XLA code in front of the TPU kernel): qf_positions writes a
// whole build's positions for qf_build_planes, and qf_build_span appends a
// sorted span to a partly built table in place, the incremental
// migration's step (the JAX package runs the TPU kernel over whole planes
// and ORs them in, repro/kernels/ops.py::_build_span).  See their comments
// below.
//
// Contract: the first min(n_items, *n_valid) items are valid; over them
// fq does not decrease and pos increases strictly as uint32 (the int32 cast
// of an int64 position past INT32_MAX wraps negative, and is dropped like
// one past the last slot, as long as total <= 2**31).  A position outside
// [0, total) is dropped.  Items are int32, as the TPU kernel took them: fr
// holds the uint32 remainder bit pattern.  Plane pointers must be 16-byte
// aligned (a fresh allocation is).
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_scan.cuh"

#define TILE 4096
#define THREADS 256

// First i in [0, n) with key(a[i]) >= key, or n; key() is monotone over a.
// Every lane of the calling warp takes part and gets the same answer.
template <bool UNSIGNED>
__device__ long long warp_lower_bound(const int32_t* __restrict__ a,
                                      long long n, long long key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    long long step = (hi - lo + 31) / 32;
    long long idx = lo + (lane + 1) * step - 1;
    bool ge = true;  // points past hi - 1 stand for the answer's side
    if (idx < hi) {
      long long v = UNSIGNED ? (long long)(uint32_t)a[idx] : (long long)a[idx];
      ge = v >= key;
    }
    unsigned m = __ballot_sync(0xffffffffu, ge);
    if (m == 0) return hi;  // lane 31's point was hi - 1, and below the key
    int f = __ffs(m) - 1;
    long long new_hi = min(lo + (f + 1) * step - 1, hi);
    lo = f > 0 ? lo + f * step : lo;
    hi = new_hi;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    qf_build_kernel(const int32_t* __restrict__ pos,
                    const int32_t* __restrict__ fq,
                    const int32_t* __restrict__ fr,
                    const int32_t* __restrict__ n_valid, long long n_items,
                    long long total, int32_t* __restrict__ rem,
                    uint8_t* __restrict__ occ, uint8_t* __restrict__ shf,
                    uint8_t* __restrict__ con) {
  __shared__ __align__(16) int32_t s_rem[TILE];
  __shared__ __align__(16) uint8_t s_occ[TILE];
  __shared__ __align__(16) uint8_t s_shf[TILE];
  __shared__ __align__(16) uint8_t s_con[TILE];
  __shared__ long long bounds[4];

  const long long t0 = (long long)blockIdx.x * TILE;
  const long long t1 = min(t0 + TILE, total);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (warp < 4) {
    long long n = min(n_items, (long long)max(*n_valid, 0));
    long long key = warp & 1 ? t1 : t0;
    bounds[warp] = warp < 2 ? warp_lower_bound<true>(pos, n, key)
                            : warp_lower_bound<false>(fq, n, key);
  }
  // zeros, 16 bytes a store
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < TILE / 4; c += THREADS)
    reinterpret_cast<uint4*>(s_rem)[c] = zero;
  for (int c = tid; c < TILE / 16; c += THREADS) {
    reinterpret_cast<uint4*>(s_occ)[c] = zero;
    reinterpret_cast<uint4*>(s_shf)[c] = zero;
    reinterpret_cast<uint4*>(s_con)[c] = zero;
  }
  __syncthreads();

  // the items of this tile's slots, then those of its buckets
  for (long long i = bounds[0] + tid; i < bounds[1]; i += THREADS) {
    int32_t p = pos[i], q = fq[i];
    int s = (int)(p - t0);
    s_rem[s] = fr[i];
    s_shf[s] = p != q;
    s_con[s] = i > 0 && fq[i - 1] == q;
  }
  for (long long i = bounds[2] + tid; i < bounds[3]; i += THREADS)
    s_occ[fq[i] - t0] = 1;  // a run's items all write 1
  __syncthreads();

  // each plane's tile stored once: whole 16-byte chunks, then the ragged end
  const int len = (int)(t1 - t0);
  const int vec = len & ~15;
  for (int c = tid; c < vec / 4; c += THREADS)
    reinterpret_cast<uint4*>(rem + t0)[c] = reinterpret_cast<const uint4*>(s_rem)[c];
  for (int c = tid; c < vec / 16; c += THREADS) {
    reinterpret_cast<uint4*>(occ + t0)[c] = reinterpret_cast<const uint4*>(s_occ)[c];
    reinterpret_cast<uint4*>(shf + t0)[c] = reinterpret_cast<const uint4*>(s_shf)[c];
    reinterpret_cast<uint4*>(con + t0)[c] = reinterpret_cast<const uint4*>(s_con)[c];
  }
  for (int s = vec + tid; s < len; s += THREADS) {
    rem[t0 + s] = s_rem[s];
    occ[t0 + s] = s_occ[s];
    shf[t0 + s] = s_shf[s];
    con[t0 + s] = s_con[s];
  }
}

// Writes every byte of the planes (no zeroing needed).  Returns
// cudaGetLastError(), or cudaErrorMisalignedAddress for a plane that is
// not 16-byte aligned.
extern "C" int qf_build_planes(const void* pos, const void* fq, const void* fr,
                               const void* n_valid, long long n_items,
                               long long total, void* rem, void* occ,
                               void* shf, void* con, void* stream) {
  if (((uintptr_t)rem | (uintptr_t)occ | (uintptr_t)shf | (uintptr_t)con) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (total > 0) {
    long long blocks = (total + TILE - 1) / TILE;
    qf_build_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)fq, (const int32_t*)fr,
        (const int32_t*)n_valid, n_items, total, (int32_t*)rem, (uint8_t*)occ,
        (uint8_t*)shf, (uint8_t*)con);
  }
  return (int)cudaGetLastError();
}

// qf_positions: the int32 positions of every row (the low 32 bits of the
// int64 position, as the plain version narrows it) and the overflow flag,
// set when the last valid row, and so any valid row, lies at or past
// total.  fq is the int32 stream qf_build_planes takes; *n is read on the
// card.  Bound: bytes, the valid rows of the stream read (rows past n are
// not) and every row's position written.
__global__ void __launch_bounds__(SCAN_THREADS)
    qf_positions_kernel(const int32_t* __restrict__ fq,
                        const int32_t* __restrict__ n, long long n_items,
                        long long total, uint32_t* hdr,
                        unsigned long long* status, int32_t* __restrict__ pos,
                        uint8_t* __restrict__ overflow) {
  const long long n_valid = min((long long)max(*n, 0), n_items);
  scan_tile(fq, n_items, n_valid, INT_MIN, 0, hdr, status,
            [&](long long i, int32_t, int32_t, long long p, bool) {
              pos[i] = (int32_t)p;
              if (i == n_valid - 1) *overflow = p >= total;
            });
  if (n_valid == 0 && blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0;
}

// qf_build_span: the span's positions come from the scan with the carry
// c = *last_pos + 1, so the span computes its own positions.  fq and fr are
// the int64 streams of the migration, read as they are.  Probe positions
// strictly increase past every slot the earlier appends wrote, so the
// rem/shf/con stores of a span touch only fresh slots; occ stores can land
// on a bucket an earlier append marked, and they all write 1.  Row 0's
// predecessor for the continuation bit is *last_fq.  A position outside
// [0, total) is dropped, and its bucket is still marked.  The scalars are
// read and written on the card: n_out = n + k, overflow_out = overflow | a
// valid row at or past total, and the carries advance to the last valid
// row (unchanged when k <= 0).  O(span) work: no pass over the table.
// Bound: bytes, the valid rows' fq and fr read and 7 plane bytes written
// an item; the plane stores land between slots the table leaves empty, so
// the card writes whole 32-byte sectors around them.
__global__ void __launch_bounds__(SCAN_THREADS)
    qf_build_span_kernel(const long long* __restrict__ fq,
                         const long long* __restrict__ fr,
                         const int32_t* __restrict__ k,
                         const int32_t* __restrict__ n,
                         const uint8_t* __restrict__ overflow,
                         const int32_t* __restrict__ last_pos,
                         const int32_t* __restrict__ last_fq, long long n_items,
                         long long total, uint32_t* hdr,
                         unsigned long long* status, int32_t* __restrict__ rem,
                         uint8_t* __restrict__ occ, uint8_t* __restrict__ shf,
                         uint8_t* __restrict__ con, int32_t* __restrict__ n_out,
                         uint8_t* __restrict__ overflow_out,
                         int32_t* __restrict__ last_pos_out,
                         int32_t* __restrict__ last_fq_out) {
  const int32_t kk = *k, lp = *last_pos, lf = *last_fq;
  const long long n_valid = min((long long)max(kk, 0), n_items);
  const int32_t carry = (int32_t)((uint32_t)lp + 1u);  // int32 + 1 wraps
  scan_tile(fq, n_items, n_valid, carry, lf, hdr, status,
            [&](long long i, int32_t q, int32_t prev, long long p, bool valid) {
              if (!valid) return;
              if (q >= 0 && q < total) occ[q] = 1;
              if (p >= 0 && p < total) {
                rem[p] = (int32_t)fr[i];
                shf[p] = p != q;
                con[p] = q == prev;
              }
              if (i == n_valid - 1) {
                *last_pos_out = (int32_t)p;
                *last_fq_out = q;
                *overflow_out = *overflow | (p >= total);
              }
            });
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_out = (int32_t)((uint32_t)*n + (uint32_t)kk);
    if (n_valid == 0) {
      *last_pos_out = lp;
      *last_fq_out = lf;
      *overflow_out = *overflow;
    }
  }
}

static unsigned scan_blocks(long long n_items) {
  return n_items > 0 ? (unsigned)((n_items + SCAN_TILE - 1) / SCAN_TILE) : 1u;
}

// Writes pos and *overflow.  The scratch is the caller's, zeroed when
// allocated, and must hold 2 + tiles 64-bit words; launches sharing it must
// be ordered on one stream.  Returns cudaGetLastError().
extern "C" int qf_positions(const void* fq, const void* n, long long n_items,
                            long long total, void* scratch, void* pos,
                            void* overflow, void* stream) {
  qf_positions_kernel<<<scan_blocks(n_items), SCAN_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)fq, (const int32_t*)n, n_items, total,
      (uint32_t*)scratch, (unsigned long long*)scratch + 2, (int32_t*)pos,
      (uint8_t*)overflow);
  return (int)cudaGetLastError();
}

// Writes the span's slots and buckets into the given planes and the four
// scalar outputs; the scratch as for qf_positions.  Returns
// cudaGetLastError().
extern "C" int qf_build_span(const void* fq, const void* fr, const void* k,
                             const void* n, const void* overflow,
                             const void* last_pos, const void* last_fq,
                             long long n_items, long long total, void* scratch,
                             void* rem, void* occ, void* shf, void* con,
                             void* n_out, void* overflow_out,
                             void* last_pos_out, void* last_fq_out,
                             void* stream) {
  qf_build_span_kernel<<<scan_blocks(n_items), SCAN_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const long long*)fq, (const long long*)fr, (const int32_t*)k,
      (const int32_t*)n, (const uint8_t*)overflow, (const int32_t*)last_pos,
      (const int32_t*)last_fq, n_items, total, (uint32_t*)scratch,
      (unsigned long long*)scratch + 2, (int32_t*)rem, (uint8_t*)occ,
      (uint8_t*)shf, (uint8_t*)con, (int32_t*)n_out, (uint8_t*)overflow_out,
      (int32_t*)last_pos_out, (int32_t*)last_fq_out);
  return (int)cudaGetLastError();
}
