// Bulk quotient-filter build: scatter sorted fingerprints into slot planes.
//
// Replaces the TPU kernel repro/kernels/qf_build.py::qf_build_planes.
// Probe positions are strictly increasing, so every valid item owns its
// slot and one thread per item writes it: no tiles, no one-hot reduction.
// occ[fq] = 1 is written by every item of a run; the writes carry the
// same value, so their order does not matter.  Items are int32, as the
// TPU kernel took them: fr holds the uint32 remainder bit pattern, and a
// position outside [0, total) is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void qf_build_kernel(const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ fq,
                                const int32_t* __restrict__ fr,
                                const int32_t* __restrict__ n_valid,
                                long long n_items, long long total,
                                int32_t* __restrict__ rem,
                                uint8_t* __restrict__ occ,
                                uint8_t* __restrict__ shf,
                                uint8_t* __restrict__ con) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_items || i >= *n_valid) return;
  int32_t q = fq[i];
  if (q >= 0 && q < total) occ[q] = 1;
  int32_t p = pos[i];
  if (p < 0 || p >= total) return;  // slack exhausted: dropped, as in JAX
  rem[p] = fr[i];
  shf[p] = p != q;
  con[p] = i > 0 && fq[i - 1] == q;
}

// Planes must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int qf_build_planes(const void* pos, const void* fq, const void* fr,
                               const void* n_valid, long long n_items,
                               long long total, void* rem, void* occ,
                               void* shf, void* con, void* stream) {
  if (n_items > 0) {
    const int threads = 256;
    long long blocks = (n_items + threads - 1) / threads;
    qf_build_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)fq, (const int32_t*)fr,
        (const int32_t*)n_valid, n_items, total, (int32_t*)rem, (uint8_t*)occ,
        (uint8_t*)shf, (uint8_t*)con);
  }
  return (int)cudaGetLastError();
}
