// Shared device helpers for the port's Hopper kernels.
//
// Histogram accumulators: float value channels accumulate in double, so a
// bin's sum is exact up to ~1e-13 relative whatever order the atomics land
// in, and the f32 result read back is the same from run to run (and equal
// to the plain PyTorch version's f64 index_add_). int8 value channels
// (quantized gradients) accumulate exactly in int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LGBT_MAX_C 4          // value channels a launch accepts
#define LGBT_THREADS 256      // threads per block of every kernel here
#define LGBT_SMEM_HIST_BYTES 32768  // private shared-memory histogram cap

template <typename V> struct AccOf;
template <> struct AccOf<float> { typedef double T; };
template <> struct AccOf<int8_t> { typedef int T; };

// hist[k, c, f, bin] += vals[c, r] for every feature f of row r: one atomic
// per (channel, feature), bins >= B add nothing (the one-hot of the TPU
// kernel never matches them either). X is feature-major [F, N] uint8.
template <typename V, typename A>
__device__ __forceinline__ void add_row(A* hist, const uint8_t* __restrict__ X,
                                        const V* __restrict__ vals,
                                        long long N, int F, int C, int B,
                                        long long r, int k) {
  A v[LGBT_MAX_C];
  bool any = false;
#pragma unroll
  for (int c = 0; c < LGBT_MAX_C; ++c) {
    v[c] = c < C ? (A)vals[(long long)c * N + r] : (A)0;
    any |= v[c] != (A)0;
  }
  if (!any) return;
  A* base = hist + (long long)k * C * F * B;
  for (int f = 0; f < F; ++f) {
    const int b = X[(long long)f * N + r];
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < LGBT_MAX_C; ++c) {
      if (c < C && v[c] != (A)0) atomicAdd(base + (c * F + f) * B + b, v[c]);
    }
  }
}

// out[i] = (float)acc[i]: the f64 accumulators rounded once to f32.
static __global__ void acc_to_f32_kernel(const double* __restrict__ acc,
                                  float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (float)acc[i];
}

static inline int lgbt_grid(long long n, int num_sms, int per_sm) {
  long long want = (n + LGBT_THREADS - 1) / LGBT_THREADS;
  long long cap = (long long)num_sms * per_sm;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}
