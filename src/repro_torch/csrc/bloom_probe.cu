// Bloom read side: the AND of k cell reads per query.
//
// Replaces the TPU kernel repro/kernels/bloom_block.py::bloom_probe_tiles
// (body _make_probe_kernel).  The TPU kernel needed queries sorted by bin
// so that a tile could prefetch one 2*wblk-cell window and read it by
// one-hot gathers, and it flagged the tiles whose bins left the window.
// Here one thread per query reads its k cells directly, in the cells' own
// width (uint8 bits, or int16 holding uint16 counters), and stops at the
// first zero.  Queries come in any order and nothing overflows.  An index
// outside [0, ncells) reads as an empty cell.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename Cell>
__global__ void bloom_probe_kernel(const Cell* __restrict__ cells,
                                   long long ncells,
                                   const int32_t* __restrict__ idx,
                                   long long n, int k,
                                   uint8_t* __restrict__ hit) {
  long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int32_t* row = idx + q * k;
  uint8_t all = 1;
  for (int j = 0; j < k; ++j) {
    int32_t c = row[j];
    if (c < 0 || c >= ncells || cells[c] == 0) {
      all = 0;
      break;
    }
  }
  hit[q] = all;
}

template <typename Cell>
static int launch(const void* cells, long long ncells, const void* idx,
                  long long n, int k, void* hit, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    bloom_probe_kernel<Cell><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const Cell*)cells, ncells, (const int32_t*)idx, n, k, (uint8_t*)hit);
  }
  return (int)cudaGetLastError();
}

// idx is (n, k) int32, row-major; hit is n bytes.  Return cudaGetLastError().
extern "C" int bloom_probe_u8(const void* cells, long long ncells,
                              const void* idx, long long n, int k, void* hit,
                              void* stream) {
  return launch<uint8_t>(cells, ncells, idx, n, k, hit, stream);
}

extern "C" int bloom_probe_i16(const void* cells, long long ncells,
                               const void* idx, long long n, int k, void* hit,
                               void* stream) {
  return launch<int16_t>(cells, ncells, idx, n, k, hit, stream);
}
