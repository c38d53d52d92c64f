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
// its slot; the zeroed spans are written once. Past LGBT_LEAF_CAP leaves
// a row also reads two words of the global leaf maps (L2 hits), and the
// prologue and epilogue write at most 2 x 128 words.
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

// GM: the leaf maps in global memory (gmap: applied, then candidates, L
// words each; wave_table.cuh), else in the block's shared memory.
template <bool GM>
__global__ void __launch_bounds__(LGBT_THREADS)
wave_member_kernel(const uint8_t* __restrict__ X,
                   const int* __restrict__ lor_in,
                   const int* __restrict__ table, int* __restrict__ lor_out,
                   int* __restrict__ slot, long long N, int F, int K,
                   int leaf_cap, const int* __restrict__ gmap, void* z0,
                   long long z0_bytes, void* z1, long long z1_bytes) {
  __shared__ int app_p[LGBT_T_ENTRIES], cand_p[LGBT_T_ENTRIES];
  __shared__ __align__(4) signed char app_of[GM ? 4 : LGBT_LEAF_CAP],
      cand_of[GM ? 4 : LGBT_LEAF_CAP];
  lgbt_load_table(table, K, GM ? 0 : leaf_cap, true, app_p, cand_p, app_of,
                  cand_of);
  const LgbtMap<GM> amap = lgbt_map<GM>(app_of, gmap, leaf_cap);
  const LgbtMap<GM> cmap = lgbt_map<GM>(cand_of, gmap + leaf_cap, leaf_cap);
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long r = tid; r < N; r += nthreads) {
    const int nl = lgbt_relabel(lor_in[r], app_p, amap, nl0, X, N, F, r);
    lor_out[r] = nl;
    const int kc = cmap(nl);
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

// gmap null: the shared maps (leaf_cap <= LGBT_LEAF_CAP); else the global
// maps, written by a prologue launch and cleared by an epilogue launch.
static inline void lgbt_wave_member_launch(const uint8_t* X, const int* lor_in,
                                           const int* table, int* lor_out,
                                           int* slot, long long N, int F,
                                           int K, int leaf_cap, int* gmap,
                                           void* z0, long long z0_bytes,
                                           void* z1, long long z1_bytes,
                                           int num_sms, cudaStream_t st) {
  const int grid = lgbt_grid(N, num_sms, 8);
  if (!gmap) {
    wave_member_kernel<false><<<grid, LGBT_THREADS, 0, st>>>(
        X, lor_in, table, lor_out, slot, N, F, K, leaf_cap, nullptr, z0,
        z0_bytes, z1, z1_bytes);
    return;
  }
  const int* cand = table + 7 * LGBT_T_ENTRIES;
  lgbt_gmap_launch(gmap, leaf_cap, table, LGBT_T_ENTRIES, cand, K, nullptr,
                   0, 0, st);
  wave_member_kernel<true><<<grid, LGBT_THREADS, 0, st>>>(
      X, lor_in, table, lor_out, slot, N, F, K, leaf_cap, gmap, z0, z0_bytes,
      z1, z1_bytes);
  lgbt_gmap_launch(gmap, leaf_cap, table, LGBT_T_ENTRIES, cand, K, nullptr,
                   0, 2, st);
}
