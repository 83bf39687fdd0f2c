// Binary-fuse membership probe: T[p0] ^ T[p1] ^ T[p2] == fp, one thread
// per query.
//
// Replaces the TPU kernel repro/kernels/fuse_probe.py::fuse_probe_tiles
// (body _fuse_probe_kernel).  The TPU kernel sorted queries by p0 so that
// a tile of them could read all three cells from one scalar-prefetched
// 2*wblk-cell window by one-hot contractions, and flagged tiles whose
// positions outran the window for an exact fallback.  All of that worked
// around Mosaic's lack of a dynamic gather.  Here each thread reads its
// query's three positions and fingerprint (coalesced), gathers the three
// cells through the read-only cache, and writes one byte: queries come in
// any order, and there is no window, no overflow output and no host sync.
// A position outside [0, slots) answers "absent" instead of reading out
// of bounds.
//
// Bound: bytes.  16 bytes of query in, three 4-byte cells gathered, one
// byte out; each gather is a random 32-byte sector of the table.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fuse_probe_kernel(const int32_t* __restrict__ table,
                                  long long slots,
                                  const int32_t* __restrict__ p0,
                                  const int32_t* __restrict__ p1,
                                  const int32_t* __restrict__ p2,
                                  const int32_t* __restrict__ fp, long long n,
                                  uint8_t* __restrict__ hit) {
  long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= n) return;
  int32_t a = p0[q], b = p1[q], c = p2[q];
  bool inside = a >= 0 && a < slots && b >= 0 && b < slots && c >= 0 &&
                c < slots;
  if (!inside) {
    hit[q] = 0;
    return;
  }
  int32_t got = __ldg(table + a) ^ __ldg(table + b) ^ __ldg(table + c);
  hit[q] = got == fp[q];
}

// table: int32 (slots,); p0/p1/p2/fp: int32 (n,); hit: n bytes.
// Returns cudaGetLastError().
extern "C" int fuse_probe(const void* table, long long slots, const void* p0,
                          const void* p1, const void* p2, const void* fp,
                          long long n, void* hit, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    fuse_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, slots, (const int32_t*)p0, (const int32_t*)p1,
        (const int32_t*)p2, (const int32_t*)fp, n, (uint8_t*)hit);
  }
  return (int)cudaGetLastError();
}
