// Row-wise multi-value slot histogram into the flat per-feature-offset
// buffer: out[k, c, offset[f] + bin(f, r)] += vals[c, r] for every storage
// column f of every row r with slot[r] = k in [0, K); a bin at or past the
// column's width adds nothing.
//
// Replaces two Pallas kernels of lightgbm_tpu/ops/histogram_rowwise.py:
//   lgbt_hist_rowwise         <- build_histogram_slots_rowwise_flat
//                                (`_rowwise_kernel`, pallas_call at :213):
//                                bins from the plain [F, N] uint8 storage;
//   lgbt_hist_rowwise_packed  <- build_histogram_slots_rowwise_packed_flat
//                                (`_rowwise_packed_kernel`, pallas_call at
//                                :431): bins of <= 16-bin columns from
//                                4-bit nibbles (low nibble = even nibble
//                                index, byte pos / 2), the rest from an
//                                unpacked remainder.
// The TPU kernels concatenate every column's one-hot at its own 8-aligned
// width into one MXU contraction per column chunk. On Hopper the direct
// form is a scatter-add: one row per thread, walking its F columns, one
// atomic per (column, channel) into the flat buffer.
//
// Bound: bytes. Each row is read once (F bin bytes, or about half of that
// for nibble-packed columns, C value words and one slot word); the flat
// output is written once. As in hist_slots.cu the atomic throughput is
// what limits it in practice. Design: the hist_slots.cu accumulation
// scheme (common.cuh): float channels accumulate in f64 and are rounded
// once, so the flat buffer equals the col-wise histogram bit for bit after
// expansion. The K*C*total accumulators are privatised in shared memory
// when they fit in what a block opts into (LGBT_SMEM_OPTIN_BYTES: the root
// histogram of a 39-column, 256-bin table is 80 KB in f64), each block
// flushing its copy once; else the atomics go to global accumulators
// resident in the 50 MB L2. The per-column descriptors
// (offset, width, and for the packed form nibble and remainder positions)
// are read through the read-only cache: every thread of a warp reads the
// same one.
#include "common.cuh"

// desc rows: 0 offset, 1 width, 2 nibble index (-1: remainder), 3
// remainder row
template <bool PACKED>
__device__ __forceinline__ int rw_bin(const uint8_t* __restrict__ X,
                                      const uint8_t* __restrict__ Xu,
                                      const int* __restrict__ desc, int F,
                                      long long N, int f, long long r) {
  if (!PACKED) return X[(long long)f * N + r];
  const int p = __ldg(desc + 2 * F + f);
  if (p >= 0) return (X[(long long)(p >> 1) * N + r] >> (4 * (p & 1))) & 15;
  return Xu[(long long)__ldg(desc + 3 * F + f) * N + r];
}

template <typename V, bool SMEM, bool PACKED>
__global__ void __launch_bounds__(LGBT_THREADS)
hist_rowwise_kernel(const uint8_t* __restrict__ X,
                    const uint8_t* __restrict__ Xu, const V* __restrict__ vals,
                    const int* __restrict__ slot, const int* __restrict__ desc,
                    typename AccOf<V>::T* __restrict__ acc, long long N,
                    int F, int C, int K, int total) {
  typedef typename AccOf<V>::T A;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int hsize = K * C * total;
  if (SMEM) {
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = (A)0;
    __syncthreads();
  }
  A* dst = SMEM ? sh : acc;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    const int k = slot ? slot[r] : 0;
    if ((unsigned)k >= (unsigned)K) continue;
    A v[LGBT_MAX_C];
    bool any = false;
#pragma unroll
    for (int c = 0; c < LGBT_MAX_C; ++c) {
      v[c] = c < C ? (A)vals[(long long)c * N + r] : (A)0;
      any |= v[c] != (A)0;
    }
    if (!any) continue;
    A* base = dst + (long long)k * C * total;
    for (int f = 0; f < F; ++f) {
      const int b = rw_bin<PACKED>(X, Xu, desc, F, N, f, r);
      if (b >= __ldg(desc + F + f)) continue;
      const int col = __ldg(desc + f) + b;
#pragma unroll
      for (int c = 0; c < LGBT_MAX_C; ++c)
        if (c < C && v[c] != (A)0) atomicAdd(base + c * total + col, v[c]);
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < hsize; i += blockDim.x)
      if (sh[i] != (A)0) atomicAdd(acc + i, sh[i]);
  }
}

template <typename V, bool PACKED>
static void launch(const uint8_t* X, const uint8_t* Xu, const V* vals,
                   const int* slot, const int* desc,
                   typename AccOf<V>::T* acc, long long N, int F, int C,
                   int K, int total, int num_sms, cudaStream_t stream) {
  const size_t hbytes =
      (size_t)K * C * total * sizeof(typename AccOf<V>::T);
  if (hbytes <= LGBT_SMEM_OPTIN_BYTES) {
    if (hbytes > 48 * 1024)
      cudaFuncSetAttribute(hist_rowwise_kernel<V, true, PACKED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)hbytes);
    hist_rowwise_kernel<V, true, PACKED>
        <<<lgbt_grid(N, num_sms, lgbt_smem_blocks_per_sm(hbytes)),
           LGBT_THREADS, hbytes, stream>>>(X, Xu, vals, slot, desc, acc, N,
                                           F, C, K, total);
  } else {
    hist_rowwise_kernel<V, false, PACKED>
        <<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, stream>>>(
            X, Xu, vals, slot, desc, acc, N, F, C, K, total);
  }
}

template <bool PACKED>
static int run(const void* X, const void* Xu, const void* vals, int vals_int8,
               const void* slot, const void* desc, void* out, void* acc,
               long long N, int F, int C, int K, int total, int num_sms,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_int8) {
    launch<int8_t, PACKED>((const uint8_t*)X, (const uint8_t*)Xu,
                           (const int8_t*)vals, (const int*)slot,
                           (const int*)desc, (int*)out, N, F, C, K, total,
                           num_sms, st);
  } else {
    launch<float, PACKED>((const uint8_t*)X, (const uint8_t*)Xu,
                          (const float*)vals, (const int*)slot,
                          (const int*)desc, (double*)acc, N, F, C, K, total,
                          num_sms, st);
    const long long n = (long long)K * C * total;
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

// X [F, N] uint8 storage, desc [2, F] int32 (offset, width). Output and
// accumulator conventions as lgbt_hist_slots (hist_slots.cu), over the flat
// [K, C, total] buffer. slot may be null: every row in slot 0.
extern "C" int lgbt_hist_rowwise(const void* X, const void* vals,
                                 int vals_int8, const void* slot,
                                 const void* desc, void* out, void* acc,
                                 long long N, int F, int C, int K, int total,
                                 int num_sms, void* stream) {
  return run<false>(X, nullptr, vals, vals_int8, slot, desc, out, acc, N, F,
                    C, K, total, num_sms, stream);
}

// Xp [ceil(P / 2), N] nibble-packed bytes, Xu [max(F - P, 1), N] remainder,
// desc [4, F] int32 (offset, width, nibble index or -1, remainder row or
// -1). Everything else as lgbt_hist_rowwise.
extern "C" int lgbt_hist_rowwise_packed(const void* Xp, const void* Xu,
                                        const void* vals, int vals_int8,
                                        const void* slot, const void* desc,
                                        void* out, void* acc, long long N,
                                        int F, int C, int K, int total,
                                        int num_sms, void* stream) {
  return run<true>(Xp, Xu, vals, vals_int8, slot, desc, out, acc, N, F, C,
                   K, total, num_sms, stream);
}
