// Fused multi-level cascade probe: one thread per query walks its cluster
// (qf_walk.cuh) in each of L quotient filters, in one launch.
//
// Replaces the TPU kernel repro/kernels/cascade_probe.py::cascade_probe_tiles.
// Each query arrives once, in the canonical split (fq, fr) of its p-bit
// fingerprint; the thread re-splits it for each level (q_l = f >> r_l), so
// no per-level copy of the queries is written or read.  The per-level plane
// pointers, sizes and remainder widths travel by value in the kernel's
// parameter block, so a launch copies nothing to the card first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_walk.cuh"

#define MAX_LEVELS 32

struct Levels {
  const int32_t* rem[MAX_LEVELS];
  const uint8_t* occ[MAX_LEVELS];
  const uint8_t* shf[MAX_LEVELS];
  const uint8_t* con[MAX_LEVELS];
  long long total[MAX_LEVELS];
  int r[MAX_LEVELS];
};

// fq/fr: the canonical split, fingerprint f = fq << rc | (uint32)fr.
// hit bit l is level l's verdict.
__global__ void cascade_probe_kernel(Levels lv, int L, int rc,
                                     const int32_t* __restrict__ fq,
                                     const int32_t* __restrict__ fr,
                                     long long n, int32_t* __restrict__ hit) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t f = ((uint64_t)(uint32_t)fq[i] << rc) | (uint32_t)fr[i];
  uint32_t h = 0;
  for (int l = 0; l < L; ++l) {
    int r = lv.r[l];
    uint32_t p = qf_walk(lv.rem[l], lv.occ[l], lv.shf[l], lv.con[l],
                         lv.total[l], (long long)(f >> r),
                         (int32_t)(uint32_t)(f & ((1ull << r) - 1)));
    h |= p << l;
  }
  hit[i] = (int32_t)h;
}

// rem/occ/shf/con/total/r are host arrays of L entries.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for L outside [1, 32] or a
// remainder width outside [1, 32].
extern "C" int cascade_probe(const long long* rem, const long long* occ,
                             const long long* shf, const long long* con,
                             const long long* total, const int* r, int L,
                             int rc, const void* fq, const void* fr,
                             long long n, void* hit, void* stream) {
  if (L < 1 || L > MAX_LEVELS || rc < 1 || rc > 32)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    if (r[l] < 1 || r[l] > 32) return (int)cudaErrorInvalidValue;
    lv.rem[l] = (const int32_t*)rem[l];
    lv.occ[l] = (const uint8_t*)occ[l];
    lv.shf[l] = (const uint8_t*)shf[l];
    lv.con[l] = (const uint8_t*)con[l];
    lv.total[l] = total[l];
    lv.r[l] = r[l];
  }
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    cascade_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        lv, L, rc, (const int32_t*)fq, (const int32_t*)fr, n, (int32_t*)hit);
  }
  return (int)cudaGetLastError();
}
