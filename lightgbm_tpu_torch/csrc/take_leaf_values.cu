// The score update of a boosting round, scores[r] += values[leaf_of_row[r]]
// (accumulate = 1), and the plain gather out[r] = values[leaf_of_row[r]]
// (accumulate = 0); rows whose leaf id is outside [0, L) add (or get) 0.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::take_leaf_values_pallas
// (pallas_call at :340), which the JAX package adds to the scores as
// `scores_k + take_leaf_values(tree.leaf_value * lr, leaf_of_row)`
// (lightgbm_tpu/models/gbdt.py:912-913). The TPU kernel contracts a one-hot
// of the leaf ids against the value table on the MXU because XLA's gather
// from a small table runs far below HBM speed there.
//
// Bound: bytes. The in-place form reads a leaf id and a score and writes
// the score, 12 B per row, in one launch; the gather-then-add it replaces
// moved 20 B per row over two launches and an [N] temporary. Design: the
// table (L <= 4096 floats) is staged in shared memory once per block (past
// 4096 leaves each row reads its value from global memory through __ldg:
// 512 KB at L = 131072, held in L2); each
// thread moves 16 B per access (int4 of leaf ids, float4 of scores) with a
// scalar tail for N % 4 (or a scalar pass when a pointer is not 16-byte
// aligned); the grid is one wave of 8 blocks per SM. The add is one
// __fadd_rn, the f32 add torch does, so the scores are bitwise those of
// `scores += values[leaf_of_row]`.
#include "common.cuh"

// values[l], or 0 outside [0, L): from the staged table (STAGE) or from
// global memory through the read-only cache
template <bool STAGE>
__device__ __forceinline__ float leaf_pick(const float* tab, int L, int l) {
  if ((unsigned)l >= (unsigned)L) return 0.0f;
  return STAGE ? tab[l] : __ldg(tab + l);
}

template <bool ADD, bool STAGE>
__device__ __forceinline__ float leaf_out(float s, const float* tab, int L,
                                          int l) {
  return ADD ? __fadd_rn(s, leaf_pick<STAGE>(tab, L, l))
             : leaf_pick<STAGE>(tab, L, l);
}

// STAGE: the L <= LGBT_LEAF_CAP values staged in shared memory; else
// (past the cap, L up to 2^31) read from `values` through __ldg
template <bool ADD, bool VEC, bool STAGE>
__global__ void __launch_bounds__(LGBT_THREADS)
leaf_values_kernel(const float* __restrict__ values, int L,
                   const int* __restrict__ lor, float* __restrict__ out,
                   long long N) {
  extern __shared__ float smem_tab[];
  const float* tab = values;
  if (STAGE) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) smem_tab[i] = values[i];
    __syncthreads();
    tab = smem_tab;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long nq = N >> 2;
    const int4* l4 = reinterpret_cast<const int4*>(lor);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long q = t0; q < nq; q += stride) {
      const int4 l = l4[q];
      float4 s = ADD ? o4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      s.x = leaf_out<ADD, STAGE>(s.x, tab, L, l.x);
      s.y = leaf_out<ADD, STAGE>(s.y, tab, L, l.y);
      s.z = leaf_out<ADD, STAGE>(s.z, tab, L, l.z);
      s.w = leaf_out<ADD, STAGE>(s.w, tab, L, l.w);
      o4[q] = s;
    }
    done = nq << 2;
  }
  for (long long r = done + t0; r < N; r += stride)
    out[r] = leaf_out<ADD, STAGE>(ADD ? out[r] : 0.f, tab, L, lor[r]);
}

template <bool ADD, bool STAGE>
static void launch(const float* values, int L, const int* lor, float* out,
                   long long N, int num_sms, cudaStream_t st) {
  const bool vec = ((uintptr_t)lor % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int grid = lgbt_grid(vec ? (N + 3) / 4 : N, num_sms, 8);
  const size_t smem = STAGE ? (size_t)L * sizeof(float) : 0;
  if (vec)
    leaf_values_kernel<ADD, true, STAGE><<<grid, LGBT_THREADS, smem, st>>>(
        values, L, lor, out, N);
  else
    leaf_values_kernel<ADD, false, STAGE><<<grid, LGBT_THREADS, smem, st>>>(
        values, L, lor, out, N);
}

template <bool ADD>
static void launch_any(const float* values, int L, const int* lor,
                       float* out, long long N, int num_sms, cudaStream_t st) {
  if (L <= LGBT_LEAF_CAP)
    launch<ADD, true>(values, L, lor, out, N, num_sms, st);
  else
    launch<ADD, false>(values, L, lor, out, N, num_sms, st);
}

// accumulate = 1: out holds the scores and is updated in place.
extern "C" int lgbt_take_leaf_values(const void* values, int L,
                                     const void* lor, void* out, long long N,
                                     int accumulate, int num_sms,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (accumulate)
    launch_any<true>((const float*)values, L, (const int*)lor, (float*)out,
                     N, num_sms, st);
  else
    launch_any<false>((const float*)values, L, (const int*)lor, (float*)out,
                      N, num_sms, st);
  return (int)cudaGetLastError();
}
