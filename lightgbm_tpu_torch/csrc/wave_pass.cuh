// The row sweep of the wave megakernel: apply the wave's splits to
// leaf_of_row, find each row's candidate entry on its NEW leaf, and add the
// rows that land in a candidate's smaller child into that slot's f64 (or
// int32) accumulators. wave_pass.cu launches it alone; wave_pass_fused.cu
// launches it before the split scan of every child (split_scan.cuh).
#pragma once

#include "wave_table.cuh"

template <typename V, bool SMEM>
__global__ void __launch_bounds__(LGBT_THREADS)
wave_pass_kernel(const uint8_t* __restrict__ X, const V* __restrict__ vals,
                 const int* __restrict__ lor_in, const int* __restrict__ table,
                 int* __restrict__ lor_out,
                 typename AccOf<V>::T* __restrict__ acc, long long N, int F,
                 int C, int K, int B, int leaf_cap) {
  typedef typename AccOf<V>::T A;
  __shared__ int app_p[LGBT_T_ENTRIES], cand_p[LGBT_T_ENTRIES];
  __shared__ signed char app_of[LGBT_LEAF_CAP], cand_of[LGBT_LEAF_CAP];
  extern __shared__ __align__(8) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int hsize = K * C * F * B;
  if (SMEM)
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = (A)0;
  lgbt_load_table(table, K, leaf_cap, true, app_p, cand_p, app_of, cand_of);
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  A* dst = SMEM ? sh : acc;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    const int nl = lgbt_relabel(lor_in[r], app_p, app_of, leaf_cap, nl0, X,
                                N, F, r);
    lor_out[r] = nl;
    const int kc = (unsigned)nl < (unsigned)leaf_cap ? cand_of[nl] : -1;
    if (kc < 0) continue;
    const int p = cand_p[kc];
    const bool sil = ((unsigned)p >> 23) & 1u;
    if (lgbt_go_left(p, X, N, F, r) != sil) continue;
    add_row<V, A>(dst, X, vals, N, F, C, B, r, kc);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < hsize; i += blockDim.x)
      if (sh[i] != (A)0) atomicAdd(acc + i, sh[i]);
  }
}

template <typename V>
static void lgbt_wave_pass_launch(const uint8_t* X, const V* vals,
                                  const int* lor_in, const int* table,
                                  int* lor_out, typename AccOf<V>::T* acc,
                                  long long N, int F, int C, int K, int B,
                                  int leaf_cap, int num_sms,
                                  cudaStream_t stream) {
  const size_t hbytes = (size_t)K * C * F * B * sizeof(typename AccOf<V>::T);
  if (hbytes <= LGBT_SMEM_HIST_BYTES) {
    wave_pass_kernel<V, true>
        <<<lgbt_grid(N, num_sms, 4), LGBT_THREADS, hbytes, stream>>>(
            X, vals, lor_in, table, lor_out, acc, N, F, C, K, B, leaf_cap);
  } else {
    wave_pass_kernel<V, false>
        <<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, stream>>>(
            X, vals, lor_in, table, lor_out, acc, N, F, C, K, B, leaf_cap);
  }
}

