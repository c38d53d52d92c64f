// K-slot histogram: hist[k, c, f, b] = sum_r vals[c, r] * [slot[r] == k] *
// [X[f, r] == b]; rows whose slot is outside [0, K) add nothing.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::build_histogram_slots_pallas
// (pallas_call at :280) and its K=1 wrapper build_histogram_pallas (:742).
// The TPU kernel builds a one-hot of the bins in VMEM and contracts it on
// the MXU, because a TPU has no atomics. On Hopper the direct form is a
// scatter-add: each row reads its slot and its F bins and adds its C values.
//
// Bound: bytes. Each row is read once (F bin bytes, C value words, one slot
// word); the output is written once. What limits this kernel in practice is
// the atomic throughput, F*C atomics per row. Design: when the K*C*F*B
// accumulators fit in shared memory (the root histogram: K=1, C=2, F=28,
// B=64 is 28 KB in f64; at F=39, B=256 it is 160 KB, which a block opts
// into, up to LGBT_SMEM_OPTIN_BYTES), each block privatises them there and
// flushes once; otherwise the atomics go to the global accumulators, which
// at K=128 (3.7 MB in f64) stay resident in the 50 MB L2. Float channels
// accumulate in f64 (common.cuh), so the result does not depend on the
// order of the adds.
#include "common.cuh"

template <typename V, bool SMEM>
__global__ void __launch_bounds__(LGBT_THREADS)
hist_slots_kernel(const uint8_t* __restrict__ X, const V* __restrict__ vals,
                  const int* __restrict__ slot,
                  typename AccOf<V>::T* __restrict__ acc, long long N, int F,
                  int C, int K, int B) {
  typedef typename AccOf<V>::T A;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int hsize = K * C * F * B;
  if (SMEM) {
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = (A)0;
    __syncthreads();
  }
  A* dst = SMEM ? sh : acc;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    const int k = slot ? slot[r] : 0;
    if ((unsigned)k >= (unsigned)K) continue;
    add_row<V, A>(dst, X, vals, N, F, C, B, r, k);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < hsize; i += blockDim.x)
      if (sh[i] != (A)0) atomicAdd(acc + i, sh[i]);
  }
}

template <typename V>
static void launch(const uint8_t* X, const V* vals, const int* slot,
                   typename AccOf<V>::T* acc, long long N, int F, int C,
                   int K, int B, int num_sms, cudaStream_t stream) {
  const size_t hbytes = (size_t)K * C * F * B * sizeof(typename AccOf<V>::T);
  if (hbytes <= LGBT_SMEM_OPTIN_BYTES) {
    if (hbytes > 48 * 1024)
      cudaFuncSetAttribute(hist_slots_kernel<V, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)hbytes);
    hist_slots_kernel<V, true>
        <<<lgbt_grid(N, num_sms, lgbt_smem_blocks_per_sm(hbytes)),
           LGBT_THREADS, hbytes, stream>>>(X, vals, slot, acc, N, F, C, K,
                                           B);
  } else {
    hist_slots_kernel<V, false>
        <<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, stream>>>(
            X, vals, slot, acc, N, F, C, K, B);
  }
}

// vals_int8 = 0: vals f32, acc f64 [K*C*F*B] zeroed by the caller, out f32
// written here. vals_int8 = 1: vals int8, out int32 zeroed by the caller is
// the accumulator itself (acc unused). slot may be null: every row in slot 0.
extern "C" int lgbt_hist_slots(const void* X, const void* vals, int vals_int8,
                               const void* slot, void* out, void* acc,
                               long long N, int F, int C, int K, int B,
                               int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_int8) {
    launch<int8_t>((const uint8_t*)X, (const int8_t*)vals, (const int*)slot,
                   (int*)out, N, F, C, K, B, num_sms, st);
  } else {
    launch<float>((const uint8_t*)X, (const float*)vals, (const int*)slot,
                  (double*)acc, N, F, C, K, B, num_sms, st);
    const long long n = (long long)K * C * F * B;
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
