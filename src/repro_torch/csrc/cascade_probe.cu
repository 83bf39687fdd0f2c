// Fused multi-level cascade probe: one thread per query answers its
// membership in each of L quotient filters, in one launch.
//
// Replaces the TPU kernel repro/kernels/cascade_probe.py::cascade_probe_tiles.
// Each query arrives once, in the canonical split (fq, fr) of its p-bit
// fingerprint; the thread re-splits it for each level (q_l = f >> r_l), so
// no per-level copy of the queries is written or read.  The per-level plane
// pointers, count pointers, sizes and remainder widths travel by value in
// the kernel's parameter block, so a launch copies nothing to the card
// first and reads nothing back.
//
// What bounds it on the H100: random reads.  Each level costs a query one
// random read of its bucket's occ byte, and an occupied bucket the walk of
// its cluster (qf_walk.cuh); every read pays a 32-byte sector of planes
// mostly larger than L2.  A cascade holds few live levels at a time (the
// main path's holds 2 of 7), so walking every level in turn read mostly
// all-zero occ planes, one dependent round trip after another.  Here each
// block reads the L level counts once into a live mask (nothing goes to
// the host); a level whose count is 0 answers 0 and none of its planes is
// read.  A thread then issues the occ reads of all live levels back to
// back, independent of each other, and walks only the levels whose bucket
// is occupied; the walk's own read of occ[q] then hits L1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qf_walk.cuh"

#define MAX_LEVELS 32

struct Levels {
  const int32_t* rem[MAX_LEVELS];
  const uint8_t* occ[MAX_LEVELS];
  const uint8_t* shf[MAX_LEVELS];
  const uint8_t* con[MAX_LEVELS];
  const int32_t* n[MAX_LEVELS];  // each level's count, a device scalar
  long long total[MAX_LEVELS];
  int r[MAX_LEVELS];
};

// fq/fr: the canonical split, fingerprint f = fq << rc | (uint32)fr.
// hit bit l is level l's verdict.
__global__ void __launch_bounds__(256)
    cascade_probe_kernel(const __grid_constant__ Levels lv, int L, int rc,
                         const int32_t* __restrict__ fq,
                         const int32_t* __restrict__ fr, long long n,
                         int32_t* __restrict__ hit) {
  __shared__ uint32_t live_s;
  if (threadIdx.x == 0) live_s = 0;
  __syncthreads();
  if (threadIdx.x < L && *lv.n[threadIdx.x] > 0)
    atomicOr(&live_s, 1u << threadIdx.x);
  __syncthreads();
  const uint32_t live = live_s;

  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t f = ((uint64_t)(uint32_t)fq[i] << rc) | (uint32_t)fr[i];
  // the occ reads of every live level, all in flight together
  uint32_t occupied = 0;
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    long long q = (long long)(f >> lv.r[l]);
    bool read = (live >> l & 1) && q < lv.total[l];
    uint8_t o = read ? __ldg(lv.occ[l] + q) : (uint8_t)0;
    occupied |= (uint32_t)(o != 0) << l;
  }
  // the cluster walks, only where the bucket is occupied
  uint32_t h = 0;
  for (uint32_t m = occupied; m; m &= m - 1) {
    int l = __ffs(m) - 1;
    int r = lv.r[l];
    uint32_t p = qf_walk(lv.rem[l], lv.occ[l], lv.shf[l], lv.con[l],
                         lv.total[l], (long long)(f >> r),
                         (int32_t)(uint32_t)(f & ((1ull << r) - 1)));
    h |= p << l;
  }
  hit[i] = (int32_t)h;
}

// rem/occ/shf/con/cnt/total/r are host arrays of L entries; cnt[l] points
// to level l's int32 count on the card.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for L outside [1, 32] or a remainder width outside
// [1, 32].
extern "C" int cascade_probe(const long long* rem, const long long* occ,
                             const long long* shf, const long long* con,
                             const long long* cnt, const long long* total,
                             const int* r, int L, int rc, const void* fq,
                             const void* fr, long long n, void* hit,
                             void* stream) {
  if (L < 1 || L > MAX_LEVELS || rc < 1 || rc > 32)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    if (r[l] < 1 || r[l] > 32) return (int)cudaErrorInvalidValue;
    lv.rem[l] = (const int32_t*)rem[l];
    lv.occ[l] = (const uint8_t*)occ[l];
    lv.shf[l] = (const uint8_t*)shf[l];
    lv.con[l] = (const uint8_t*)con[l];
    lv.n[l] = (const int32_t*)cnt[l];
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
