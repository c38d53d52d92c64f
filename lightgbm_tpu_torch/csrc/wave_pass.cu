// One row sweep per wave of the wave grower: apply the wave's splits to
// leaf_of_row, find each row's candidate entry on its NEW leaf, and add the
// rows that land in a candidate's smaller child into that slot's histogram.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_pass_pallas
// (pallas_call at :562). The TPU kernel resolves table entries with masked
// reductions over [128, R] leaf-match masks and accumulates with a one-hot
// MXU contraction. Here each row looks its entry up in a shared-memory
// leaf -> entry map (wave_table.cuh) and scatter-adds with atomics.
//
// Bound: bytes. A row reads leaf_of_row, the bins of the (at most two)
// split features it is tested on, and, if it is in a smaller child, its F
// bins and C values; it writes its new leaf id. Atomic throughput limits
// the histogram part, as in hist_slots.cu. Design: the same accumulation
// scheme as hist_slots.cu (shared-memory privatisation when the K*C*F*B
// f64 accumulators fit, else L2-resident global atomics), and the ragged
// edge is masked by the grid-stride loop.
#include "wave_pass.cuh"

// Accumulator and output conventions as lgbt_hist_slots (hist_slots.cu).
extern "C" int lgbt_wave_pass(const void* X, const void* vals, int vals_int8,
                              const void* lor_in, const void* table,
                              void* lor_out, void* out, void* acc, long long N,
                              int F, int C, int K, int B, int leaf_cap,
                              int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_int8) {
    lgbt_wave_pass_launch<int8_t>(
        (const uint8_t*)X, (const int8_t*)vals, (const int*)lor_in,
        (const int*)table, (int*)lor_out, (int*)out, N, F, C, K, B, leaf_cap,
        num_sms, st);
  } else {
    lgbt_wave_pass_launch<float>(
        (const uint8_t*)X, (const float*)vals, (const int*)lor_in,
        (const int*)table, (int*)lor_out, (double*)acc, N, F, C, K, B,
        leaf_cap, num_sms, st);
    const long long n = (long long)K * C * F * B;
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
