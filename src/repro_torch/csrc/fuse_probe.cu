// Binary-fuse membership probe with the hash in registers: canonical
// fingerprints (fq, fr) to T[p0] ^ T[p1] ^ T[p2] == fp, one thread per query.
//
// Replaces the TPU kernel repro/kernels/fuse_probe.py::fuse_probe_tiles
// (body _fuse_probe_kernel) and the fuse_hash its wrapper jitted around it
// (repro/core/fuse_filter.py::fuse_hash).  The TPU kernel sorted queries by
// p0 so that a tile of them could read all three cells from one
// scalar-prefetched 2*wblk-cell window by one-hot contractions, and flagged
// tiles whose positions outran the window for an exact fallback.  Here each
// thread reads its query's fingerprint pair (coalesced) and the table's
// construction seed (a device scalar: no host read), computes fuse_hash
// step for step in uint32 registers (the seed words, a, b, h1..h4, the
// start segment by the reference's _mulhi_seg, the three positions and the
// stored fingerprint), gathers the three cells through the read-only cache
// and writes one byte.  Queries come in any order; there is no window, no
// overflow output and no host sync.  A position outside [0, slots) answers
// "absent" instead of reading out of bounds.
//
// Bound: bytes, met as random 32-byte sectors.  8 bytes of query in, three
// 4-byte cells gathered, one byte out; each gather is a random sector of a
// table far larger than L2.  The hash is about 80 integer operations.
#include <cuda_runtime.h>
#include <stdint.h>

#define GOLD1 0x9E3779B9u
#define GOLD2 0x85EBCA77u
#define MUL1 0xC2B2AE3Du
#define MUL2 0x27D4EB2Fu

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(256)
    fuse_probe_kernel(const int32_t* __restrict__ table, long long slots,
                      const int32_t* __restrict__ fq,
                      const int32_t* __restrict__ fr,
                      const int32_t* __restrict__ fuse_seed, long long n,
                      uint32_t seg_len, uint32_t seg_count, int fp_bits,
                      uint8_t* __restrict__ hit) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = (uint32_t)__ldg(fuse_seed);
  const uint32_t a = fmix32((uint32_t)fq[i] ^ fmix32(s ^ GOLD1));
  const uint32_t b = fmix32((uint32_t)fr[i] ^ fmix32(s + GOLD2));
  const uint32_t h1 = fmix32(a ^ (b * MUL1));
  const uint32_t h2 = fmix32(b + a * MUL2);
  const uint32_t h3 = fmix32(h1 ^ (h2 * MUL1));
  const uint32_t h4 = fmix32(h2 ^ (h3 * MUL2));
  // _mulhi_seg: floor(h1 * seg_count / 2**32) in 32-bit pieces
  const uint32_t start =
      ((h1 >> 16) * seg_count + (((h1 & 0xFFFFu) * seg_count) >> 16)) >> 16;
  const uint32_t mask = seg_len - 1;
  const long long base = (long long)start * seg_len;
  const long long p0 = base + (h2 & mask);
  const long long p1 = base + seg_len + ((h2 >> 16) & mask);
  const long long p2 = base + 2ll * seg_len + (h3 & mask);
  if (p2 >= slots) {  // 0 <= p0 < p1 < p2
    hit[i] = 0;
    return;
  }
  const int32_t fp = (int32_t)(h4 >> (32 - fp_bits));  // 1 <= fp_bits <= 28
  hit[i] = (__ldg(table + p0) ^ __ldg(table + p1) ^ __ldg(table + p2)) == fp;
}

// table: int32 (slots,); fq/fr: int32 (n,); fuse_seed: one int32 on the
// card; hit: n bytes.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an fp_bits outside [1, 28].
extern "C" int fuse_probe(const void* table, long long slots, const void* fq,
                          const void* fr, const void* fuse_seed, long long n,
                          long long seg_len, long long seg_count, int fp_bits,
                          void* hit, void* stream) {
  if (fp_bits < 1 || fp_bits > 28) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    fuse_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, slots, (const int32_t*)fq, (const int32_t*)fr,
        (const int32_t*)fuse_seed, n, (uint32_t)seg_len, (uint32_t)seg_count,
        fp_bits, (uint8_t*)hit);
  }
  return (int)cudaGetLastError();
}
