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
static void launch(const uint8_t* X, const V* vals, const int* lor_in,
                   const int* table, int* lor_out,
                   typename AccOf<V>::T* acc, long long N, int F, int C, int K,
                   int B, int leaf_cap, int num_sms, cudaStream_t stream) {
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

// Accumulator and output conventions as lgbt_hist_slots (hist_slots.cu).
extern "C" int lgbt_wave_pass(const void* X, const void* vals, int vals_int8,
                              const void* lor_in, const void* table,
                              void* lor_out, void* out, void* acc, long long N,
                              int F, int C, int K, int B, int leaf_cap,
                              int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_int8) {
    launch<int8_t>((const uint8_t*)X, (const int8_t*)vals,
                   (const int*)lor_in, (const int*)table, (int*)lor_out,
                   (int*)out, N, F, C, K, B, leaf_cap, num_sms, st);
  } else {
    launch<float>((const uint8_t*)X, (const float*)vals, (const int*)lor_in,
                  (const int*)table, (int*)lor_out, (double*)acc, N, F, C, K,
                  B, leaf_cap, num_sms, st);
    const long long n = (long long)K * C * F * B;
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
