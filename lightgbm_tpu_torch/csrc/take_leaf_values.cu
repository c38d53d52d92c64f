// Exact gather out[r] = values[leaf_of_row[r]]; rows whose leaf id is
// outside [0, L) get 0.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::take_leaf_values_pallas
// (pallas_call at :340). The TPU kernel contracts a one-hot of the leaf ids
// against the value table on the MXU because XLA's gather from a small
// table runs far below HBM speed there. On Hopper a gather through the L1
// cache is the direct form: the table (L <= a few thousand floats) stays
// cached, and the result is bitwise the table entry.
//
// Bound: bytes, 4 bytes read and 4 written per row. Design: one thread per
// row, grid-stride, coalesced loads of leaf_of_row and stores of out.
#include "common.cuh"

__global__ void __launch_bounds__(LGBT_THREADS)
take_leaf_values_kernel(const float* __restrict__ values, int L,
                        const int* __restrict__ lor, float* __restrict__ out,
                        long long N) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    const int l = lor[r];
    out[r] = ((unsigned)l < (unsigned)L) ? __ldg(values + l) : 0.0f;
  }
}

extern "C" int lgbt_take_leaf_values(const void* values, int L,
                                     const void* lor, void* out, long long N,
                                     int num_sms, void* stream) {
  take_leaf_values_kernel<<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)values, L, (const int*)lor, (float*)out, N);
  return (int)cudaGetLastError();
}
