// Keys to quotient/remainder fingerprints, one thread per key.
//
// Computes repro/core/fingerprint.py::fingerprint, which is XLA code in the
// JAX package (no pallas_call): its wrappers jit the hash together with each
// probe, so XLA fuses it.  The port's plain chain carries every hash word in
// int64, masks after each operation and splits each product: about fifty
// launches a call, each writing the whole batch and reading it back.  Here
// both murmur3 fmix32 words of a key's low 32 bits stay in registers, and
// the fingerprint, the top q + r bits of the 64-bit word (hi:lo), is cut out
// of it with 64-bit shifts: every (q, r) the reference accepts (1 <= q <= 30,
// 1 <= r <= 32) takes one formula, and no shift reaches 64.
//
// Keys are int32/uint32 (4 bytes) or int64 (8 bytes, low 32 bits used);
// the pair is written as int32 (the remainder's uint32 bit pattern) or as
// int64 (the unsigned values).
//
// Bound: bytes.  A key read, two words written.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <typename K, typename O>
__global__ void __launch_bounds__(256)
    fingerprint_kernel(const K* __restrict__ keys, long long n, uint32_t s_hi,
                       uint32_t s_lo, int q, int r, O* __restrict__ fq,
                       O* __restrict__ fr) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = (uint32_t)keys[i];  // the key's low 32 bits
  const uint64_t hi = fmix32(k ^ s_hi);
  const uint64_t lo = fmix32((k + 0x9E3779B9u) ^ s_lo);
  const uint64_t f = (hi << 32 | lo) >> (64 - q - r);  // q + r <= 62
  fq[i] = (O)(uint32_t)(f >> r);
  fr[i] = (O)(uint32_t)(f & ((1ull << r) - 1));
}

template <typename K>
static void launch(const void* keys, long long n, uint32_t s_hi, uint32_t s_lo,
                   int q, int r, int out_bytes, void* fq, void* fr,
                   cudaStream_t s) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (out_bytes == 4)
    fingerprint_kernel<K, int32_t><<<blocks, threads, 0, s>>>(
        (const K*)keys, n, s_hi, s_lo, q, r, (int32_t*)fq, (int32_t*)fr);
  else
    fingerprint_kernel<K, int64_t><<<blocks, threads, 0, s>>>(
        (const K*)keys, n, s_hi, s_lo, q, r, (int64_t*)fq, (int64_t*)fr);
}

// keys: n elements of key_bytes (4 or 8); fq/fr: n elements of out_bytes
// (4 or 8).  s_hi/s_lo are the seed's two words, fmix32(2 s + 1) and
// fmix32(2 s + 2).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a width or a (q, r) the kernel does not take.
extern "C" int fingerprint(const void* keys, int key_bytes, long long n,
                           unsigned s_hi, unsigned s_lo, int q, int r,
                           int out_bytes, void* fq, void* fr, void* stream) {
  if ((key_bytes != 4 && key_bytes != 8) || (out_bytes != 4 && out_bytes != 8) ||
      q < 1 || q > 30 || r < 1 || r > 32)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (key_bytes == 4)
      launch<uint32_t>(keys, n, s_hi, s_lo, q, r, out_bytes, fq, fr, s);
    else
      launch<long long>(keys, n, s_hi, s_lo, q, r, out_bytes, fq, fr, s);
  }
  return (int)cudaGetLastError();
}
