// Bloom read side: the AND of k cell reads per query.
//
// Replaces the TPU kernel repro/kernels/bloom_block.py::bloom_probe_tiles
// (body _make_probe_kernel).  The TPU kernel needed queries sorted by bin
// so that a tile could prefetch one 2*wblk-cell window and read it by
// one-hot gathers, and it flagged the tiles whose bins left the window.
// Here one thread per query reads its k cells directly, in the cells' own
// width (uint8 bits, or int16 holding uint16 counters).  Queries come in
// any order and nothing overflows.  An index outside [0, ncells) reads as
// an empty cell.
//
// What bounds it on the H100: each cell read is a random 32-byte sector
// of a plane far larger than L2.  Reading the cells one at a time and
// stopping at the first zero reads the fewest sectors, but makes a member
// query wait on k dependent round trips; reading all k at once keeps the
// most loads in flight, but reads every sector of a fresh query that its
// first zero would have spared.  Between the two, a thread reads its
// cells in groups of GROUP: the group's indices, then its GROUP cell
// loads back to back through the read-only path, independent of each
// other; it stops after the first group that holds a zero, and masks the
// lanes of a ragged last group.  GROUP = 2 was the fastest of 2, 4, 6 and
// 12 on the H100 at the main path's shapes (kernel_turns.py, which builds
// the other widths with -DGROUP; PERF.md): at k = 12 a member query waits
// on 6 round trips instead of 12, and the wider groups lose more to the
// sectors they read past the first zero than they gain in round trips.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GROUP
#define GROUP 2
#endif

template <typename Cell>
__global__ void __launch_bounds__(256)
    bloom_probe_kernel(const Cell* __restrict__ cells, long long ncells,
                       const int32_t* __restrict__ idx, long long n, int k,
                       uint8_t* __restrict__ hit) {
  long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int32_t* row = idx + q * k;
  bool all = true;
  for (int j = 0; j < k && all; j += GROUP) {
    int32_t c[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) c[g] = j + g < k ? __ldg(row + j + g) : 0;
    Cell v[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      // past the row's end a lane reads nothing and counts as set
      bool in_row = j + g < k;
      bool in_plane = c[g] >= 0 && c[g] < ncells;
      v[g] = !in_row ? (Cell)1 : in_plane ? __ldg(cells + c[g]) : (Cell)0;
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) all &= v[g] != 0;
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

// The cells a thread reads per round trip, for counting the sectors read.
extern "C" int bloom_probe_group(void) { return GROUP; }
