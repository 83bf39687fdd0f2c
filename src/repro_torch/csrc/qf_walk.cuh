// The quotient filter's cluster walk (paper Fig. 3) for one query, shared
// by the single-table probe (qf_probe.cu) and the fused cascade probe
// (cascade_probe.cu).
//
// Planes: rem holds the uint32 remainder bit patterns; occ/shf/con are
// one byte per slot (0 or 1), as torch.bool stores them.
#pragma once

#include <stdint.h>

// Returns 1 when the fingerprint (q, r) is stored, else 0.  A walk that
// would run past the last slot (only a state whose `overflow` flag is set
// lets it) stops there and answers 0.
__device__ __forceinline__ int qf_walk(const int32_t* __restrict__ rem,
                                       const uint8_t* __restrict__ occ,
                                       const uint8_t* __restrict__ shf,
                                       const uint8_t* __restrict__ con,
                                       long long total, long long q,
                                       int32_t r) {
  if (q < 0 || q >= total || !occ[q]) return 0;
  // 1. step back to the last unshifted slot: the cluster's start, which
  //    holds the first run of the cluster at its own bucket
  long long b = q;
  while (b > 0 && shf[b]) --b;
  // 2. count the occupied buckets from there to q: q's run is the R-th
  long long R = 0;
  for (long long j = b; j <= q; ++j) R += occ[j];
  // 3. step forward to the start of the R-th run
  long long s = b;
  for (long long c = 1; c < R;) {
    if (++s >= total) return 0;
    if ((occ[s] | shf[s]) && !con[s]) ++c;
  }
  // 4. compare remainders along the run
  for (;;) {
    if (rem[s] == r) return 1;
    if (++s >= total || !con[s]) return 0;
  }
}
