// Bulk quotient-filter membership probe: one thread per query walks its
// cluster, queries in any order.
//
// Replaces the TPU kernel repro/kernels/qf_probe.py::qf_probe_tiles.  The
// TPU kernel sorted its queries by quotient, decoded one 2*wblk-slot window
// per tile of them and flagged clusters that left it; the walk (the paper's
// Fig. 3) has no window, so it needs neither the sort nor the fallback.
//
// What bounds it on the H100: random 32-byte sectors.  A walk reads a few
// bytes of each of four planes, and every byte it reads costs a sector.
// Of the four, three (occ, shf, con) carry one bit a slot in a byte each:
// 50 MB at q = 24, more than the 50 MB L2 holds beside the rest.  So a
// dense probe first packs them into three bit planes (one 32-bit word per
// 32 slots, 6.3 MB at q = 24; a streaming pass, 16 bytes a load), which
// stay in L2, and each thread walks there with whole words: the cluster's
// start by a count of leading zeros, the occupied buckets by popcounts,
// the run's start by a select over run-start words.  Only the remainders
// of the run it compares come from the rem plane.  The pack reads every
// byte of the three planes, so it pays only when the queries are many for
// the table's size; for a sparse probe (the wrapper decides) each thread
// walks the byte planes (qf_walk.cuh).  Both walks give qf_walk's answer,
// for a walk that runs off the end of an overflowed state too.
//
// Sorting the queries by quotient first, as the TPU wrapper did, was
// measured and lost: the ordering cost more than it saved (kernel_turns.py,
// PERF.md).
//
// Queries are int32, as the TPU kernel took them: fr holds the uint32
// remainder bit pattern.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_walk.cuh"

#define THREADS 256

// Eight bytes of 0 or 1 (torch.bool) to eight bits, byte i to bit i.
__device__ __forceinline__ uint32_t bits8(uint64_t x) {
  return (uint32_t)((x * 0x0102040810204080ull) >> 56);
}

__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return bits8(v.x | (uint64_t)v.y << 32) | bits8(v.z | (uint64_t)v.w << 32) << 8;
}

// Thread w packs slots [32 w, 32 w + 32) of occ, shf and con into word w of
// each bit plane; slots past the last read as 0.
__global__ void __launch_bounds__(THREADS)
    qf_pack_kernel(const uint8_t* __restrict__ occ,
                   const uint8_t* __restrict__ shf,
                   const uint8_t* __restrict__ con, long long total,
                   long long words, bool aligned, uint32_t* __restrict__ bits) {
  long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= words) return;
  const long long s0 = w * 32;
  const uint8_t* planes[3] = {occ, shf, con};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint32_t b = 0;
    if (aligned && s0 + 32 <= total) {
      const uint4* v = reinterpret_cast<const uint4*>(planes[p] + s0);
      b = bits16(__ldg(v)) | bits16(__ldg(v + 1)) << 16;
    } else {
      for (int j = 0; j < 32 && s0 + j < total; ++j)
        b |= (uint32_t)(planes[p][s0 + j] != 0) << j;
    }
    bits[p * words + w] = b;
  }
}

// qf_walk (qf_walk.cuh) over the bit planes: 1 when (q, r) is stored.
__device__ __forceinline__ int bit_walk(const uint32_t* __restrict__ occ,
                                        const uint32_t* __restrict__ shf,
                                        const uint32_t* __restrict__ con,
                                        const int32_t* __restrict__ rem,
                                        long long total, long long words,
                                        long long q, int32_t r) {
  if (q < 0 || q >= total) return 0;
  const long long w = q >> 5;
  const uint32_t upto = 0xffffffffu >> (31 - (q & 31));  // slots <= q
  const uint32_t ow = occ[w], sw = shf[w];
  if (!(ow & ~(upto >> 1) & upto)) return 0;  // occ[q]
  // 1. back to the last unshifted slot at or before q (slot 0 if none)
  uint32_t m = ~sw & upto;
  long long x = w;
  while (m == 0 && x > 0) m = ~shf[--x];
  const long long b = m ? x * 32 + 31 - __clz(m) : 0;
  const long long wb = b >> 5;
  const uint32_t from = 0xffffffffu << (b & 31);  // slots >= b
  // 2. the occupied buckets in [b, q]: q's run is the R-th
  long long R;
  if (wb == w) {
    R = __popc(ow & upto & from);
  } else {
    R = __popc(occ[wb] & from) + __popc(ow & upto);
    for (x = wb + 1; x < w; ++x) R += __popc(occ[x]);
  }
  // 3. the start of the R-th run: the (R-1)-th run start after b
  long long s = b;
  long long k = R - 1;
  if (k > 0) {
    x = wb;
    uint32_t rs = (occ[x] | shf[x]) & ~con[x] & (from << 1);
    for (int c; (c = __popc(rs)) < k;) {
      k -= c;
      if (++x >= words) return 0;  // runs off the last slot
      rs = (occ[x] | shf[x]) & ~con[x];
    }
    for (; k > 1; --k) rs &= rs - 1;
    s = x * 32 + __ffs(rs) - 1;
  }
  // 4. compare remainders along the run
  for (;;) {
    if (rem[s] == r) return 1;
    if (++s >= total || !(con[s >> 5] >> (s & 31) & 1)) return 0;
  }
}

__global__ void __launch_bounds__(THREADS)
    qf_bit_walk_kernel(const uint32_t* __restrict__ bits,
                       const int32_t* __restrict__ rem, long long total,
                       long long words, const int32_t* __restrict__ fq,
                       const int32_t* __restrict__ fr, long long n,
                       uint8_t* __restrict__ present) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  present[i] = bit_walk(bits, bits + words, bits + 2 * words, rem, total,
                        words, fq[i], fr[i]);
}

__global__ void __launch_bounds__(THREADS)
    qf_probe_kernel(const int32_t* __restrict__ rem,
                    const uint8_t* __restrict__ occ,
                    const uint8_t* __restrict__ shf,
                    const uint8_t* __restrict__ con, long long total,
                    const int32_t* __restrict__ fq,
                    const int32_t* __restrict__ fr, long long n,
                    uint8_t* __restrict__ present) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  present[i] = qf_walk(rem, occ, shf, con, total, fq[i], fr[i]);
}

static void pack(const void* occ, const void* shf, const void* con,
                 long long total, void* bits, cudaStream_t s) {
  const long long words = (total + 31) / 32;
  const bool aligned =
      ((uintptr_t)occ | (uintptr_t)shf | (uintptr_t)con) % 16 == 0;
  if (words > 0)
    qf_pack_kernel<<<(unsigned)((words + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        (const uint8_t*)occ, (const uint8_t*)shf, (const uint8_t*)con, total,
        words, aligned, (uint32_t*)bits);
}

// Packs occ, shf and con into bits: 3 * ceil(total / 32) words, the three
// bit planes one after another.  Returns cudaGetLastError().
extern "C" int qf_probe_pack(const void* occ, const void* shf, const void* con,
                             long long total, void* bits, void* stream) {
  pack(occ, shf, con, total, bits, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The walks: over the bit planes in bits (packed here first when do_pack
// is set, else already packed by qf_probe_pack), or over the byte planes
// when bits is NULL.  One call for the wrapper's whole probe, since the
// host's time to issue it counts.  Returns cudaGetLastError().
extern "C" int qf_probe(const void* rem, const void* occ, const void* shf,
                        const void* con, long long total, const void* fq,
                        const void* fr, long long n, void* present, void* bits,
                        int do_pack, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (n > 0 && bits) {
    if (do_pack) pack(occ, shf, con, total, bits, s);
    qf_bit_walk_kernel<<<blocks, THREADS, 0, s>>>(
        (const uint32_t*)bits, (const int32_t*)rem, total, (total + 31) / 32,
        (const int32_t*)fq, (const int32_t*)fr, n, (uint8_t*)present);
  } else if (n > 0) {
    qf_probe_kernel<<<blocks, THREADS, 0, s>>>(
        (const int32_t*)rem, (const uint8_t*)occ, (const uint8_t*)shf,
        (const uint8_t*)con, total, (const int32_t*)fq, (const int32_t*)fr, n,
        (uint8_t*)present);
  }
  return (int)cudaGetLastError();
}
