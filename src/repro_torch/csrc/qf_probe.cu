// Bulk quotient-filter membership probe: one thread per query walks its
// cluster in global memory (qf_walk.cuh).
//
// Replaces the TPU kernel repro/kernels/qf_probe.py::qf_probe_tiles.  The
// TPU kernel decoded a fixed 2*wblk-slot window per tile of sorted queries
// and flagged clusters that left it; the walk has no window, so it needs
// neither sorted queries nor the exact fallback.  Queries are int32, as
// the TPU kernel took them: fr holds the uint32 remainder bit pattern.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_walk.cuh"

__global__ void qf_probe_kernel(const int32_t* __restrict__ rem,
                                const uint8_t* __restrict__ occ,
                                const uint8_t* __restrict__ shf,
                                const uint8_t* __restrict__ con,
                                long long total, const int32_t* __restrict__ fq,
                                const int32_t* __restrict__ fr, long long n,
                                uint8_t* __restrict__ present) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  present[i] = qf_walk(rem, occ, shf, con, total, fq[i], fr[i]);
}

// Returns cudaGetLastError().
extern "C" int qf_probe(const void* rem, const void* occ, const void* shf,
                        const void* con, long long total, const void* fq,
                        const void* fr, long long n, void* present,
                        void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    qf_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rem, (const uint8_t*)occ, (const uint8_t*)shf,
        (const uint8_t*)con, total, (const int32_t*)fq, (const int32_t*)fr, n,
        (uint8_t*)present);
  }
  return (int)cudaGetLastError();
}
