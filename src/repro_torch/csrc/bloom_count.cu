// Bloom write side: per-cell hit counts of a flat batch of cell indices.
//
// Replaces the TPU kernel repro/kernels/bloom_block.py::bloom_count_tiles
// (body _count_kernel).  The TPU kernel sorted the indices so that each
// S-cell output tile could prefetch one window of them and reduce a
// (2S x S) one-hot match, and it flagged the tiles whose indices outran
// that window.  Here the plane is zeroed and one thread per index adds
// one to its cell with an atomic.  Integer atomics commute, so the counts
// are exact in any order: the indices need no sort and nothing overflows.
// An index outside [0, ncells), such as the INT32_MAX of a masked key,
// counts nothing.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bloom_count_kernel(const int32_t* __restrict__ idx,
                                   long long n, long long ncells,
                                   int32_t* __restrict__ counts) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t c = idx[i];
  if (c >= 0 && c < ncells) atomicAdd(&counts[c], 1);
}

// Zeroes counts (ncells int32) on the stream, then counts.  Returns
// cudaGetLastError().
extern "C" int bloom_count(const void* idx, long long n, long long ncells,
                           void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, ncells * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    bloom_count_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)idx, n, ncells, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
