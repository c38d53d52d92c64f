// Relabel only: apply the wave's splits to leaf_of_row (a tree's last
// wave, which has splits to apply and no candidates left).
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_relabel_pallas
// (pallas_call at :718), which runs the wave kernel's relabel half over
// [128, R] leaf-match masks. Here each row finds its applied entry through
// the shared-memory leaf -> entry map of wave_table.cuh.
//
// Bound: bytes. A row reads its leaf id and, when its leaf was split, one
// bin of the split feature; it writes its new leaf id. Design: one thread
// per row, grid-stride, the table decoded once per block.
#include "wave_table.cuh"

__global__ void __launch_bounds__(LGBT_THREADS)
wave_relabel_kernel(const uint8_t* __restrict__ X,
                    const int* __restrict__ lor_in,
                    const int* __restrict__ table, int* __restrict__ lor_out,
                    long long N, int F, int leaf_cap) {
  __shared__ int app_p[LGBT_T_ENTRIES];
  __shared__ signed char app_of[LGBT_LEAF_CAP];
  lgbt_load_table(table, 0, leaf_cap, false, app_p, nullptr, app_of, nullptr);
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x)
    lor_out[r] = lgbt_relabel(lor_in[r], app_p, app_of, leaf_cap, nl0, X, N,
                              F, r);
}

extern "C" int lgbt_wave_relabel(const void* X, const void* lor_in,
                                 const void* table, void* lor_out, long long N,
                                 int F, int leaf_cap, int num_sms,
                                 void* stream) {
  wave_relabel_kernel<<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)X, (const int*)lor_in, (const int*)table, (int*)lor_out,
      N, F, leaf_cap);
  return (int)cudaGetLastError();
}
