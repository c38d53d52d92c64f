// The membership pass of the wave megakernel route (kernels #3 and #9):
// per row, what the TPU kernel's row sweep decides before it accumulates
// (lightgbm_tpu/ops/histogram_pallas.py:_wave_logic):
//   1. relabel under the wave's applied entries (lgbt_relabel);
//   2. map the new leaf to its candidate entry (entries below K only);
//   3. test the row against the candidate's packed split: it lands in the
//      candidate's smaller child when it goes the way smaller_is_left says.
// It writes lor_out[r] and slot[r] = that candidate, or -1 when the row
// lands in no smaller child; the tiled engine of hist_tiles.cuh (or its
// direct route) then sums the slots' histogram. The pass also zeroes what
// the histogram launch adds into (two spans of 4-byte words), so that no
// memset runs between the two launches.
//
// Bound: bytes. A row reads its leaf id and at most two bin bytes (the
// applied and the candidate split's feature) and writes its leaf id and
// its slot; the zeroed spans are written once.
#pragma once

#include "wave_table.cuh"

// zero `bytes` (a multiple of 4) from p, 16 bytes a store where it can;
// thread tid of nthreads
__device__ __forceinline__ void lgbt_zero_span(void* p, long long bytes,
                                               long long tid,
                                               long long nthreads) {
  if (!p) return;
  const long long n16 = bytes >> 4;
  uint4* q = reinterpret_cast<uint4*>(p);
  for (long long i = tid; i < n16; i += nthreads)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
  unsigned* w = reinterpret_cast<unsigned*>(q + n16);
  for (long long i = tid; i < ((bytes & 15) >> 2); i += nthreads) w[i] = 0u;
}

__global__ void __launch_bounds__(LGBT_THREADS)
wave_member_kernel(const uint8_t* __restrict__ X,
                   const int* __restrict__ lor_in,
                   const int* __restrict__ table, int* __restrict__ lor_out,
                   int* __restrict__ slot, long long N, int F, int K,
                   int leaf_cap, void* z0, long long z0_bytes, void* z1,
                   long long z1_bytes) {
  __shared__ int app_p[LGBT_T_ENTRIES], cand_p[LGBT_T_ENTRIES];
  __shared__ __align__(4) signed char app_of[LGBT_LEAF_CAP],
      cand_of[LGBT_LEAF_CAP];
  lgbt_load_table(table, K, leaf_cap, true, app_p, cand_p, app_of, cand_of);
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long r = tid; r < N; r += nthreads) {
    const int nl = lgbt_relabel(lor_in[r], app_p, app_of, leaf_cap, nl0, X,
                                N, F, r);
    lor_out[r] = nl;
    const int kc = (unsigned)nl < (unsigned)leaf_cap ? cand_of[nl] : -1;
    int s = -1;
    if (kc >= 0) {
      const int p = cand_p[kc];
      const bool sil = ((unsigned)p >> 23) & 1u;
      if (lgbt_go_left(p, X, N, F, r) == sil) s = kc;
    }
    slot[r] = s;
  }
  lgbt_zero_span(z0, z0_bytes, tid, nthreads);
  lgbt_zero_span(z1, z1_bytes, tid, nthreads);
}

static inline void lgbt_wave_member_launch(const uint8_t* X, const int* lor_in,
                                           const int* table, int* lor_out,
                                           int* slot, long long N, int F,
                                           int K, int leaf_cap, void* z0,
                                           long long z0_bytes, void* z1,
                                           long long z1_bytes, int num_sms,
                                           cudaStream_t st) {
  wave_member_kernel<<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, st>>>(
      X, lor_in, table, lor_out, slot, N, F, K, leaf_cap, z0, z0_bytes, z1,
      z1_bytes);
}
