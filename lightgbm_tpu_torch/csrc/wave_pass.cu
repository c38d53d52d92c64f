// One row sweep per wave of the wave grower: apply the wave's splits to
// leaf_of_row, find each row's candidate entry on its NEW leaf, and sum
// the rows that land in a candidate's smaller child into that slot's
// histogram.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_pass_pallas
// (pallas_call at :562). The TPU kernel resolves table entries with masked
// reductions over [128, R] leaf-match masks and accumulates with a one-hot
// MXU contraction in the same grid step. Here a wave is two steps:
//   1. the membership pass (wave_member.cuh): each row looks its entries up
//      in shared-memory leaf -> entry maps, writes its new leaf id and its
//      slot (the candidate whose smaller child it lands in, else -1), and
//      the pass zeroes what step 2 adds into;
//   2. the slot histogram by the tiled engine of hist_tiles.cuh on kernel
//      #1's plan (ops/histogram_cuda.py:plan_hist_tiles, chosen on N so
//      that no host read is needed): rows grouped by slot at K > 1,
//      (slot, feature) tiles of <= 48 KB, the warp merge at B > 64, the
//      channel pairing at K = 1, the tiles' last blocks rounding to f32,
//      and, but with the pairing, a row's bins read four columns ahead of
//      its adds (a wave's smaller children leave few rows to a block, which
//      then waits on each row's chain of loads and compare-and-swaps); or,
//      for little work, the direct sweep, which rounds its f64 sums in the
//      same cooperative launch.
//
// Bound: bytes. A row reads its leaf id and at most two bin bytes and
// writes its leaf id and its slot; a row of a smaller child also reads its
// F bins and C values; the output is written once. What limits the
// histogram is the engine's shared-memory adds (hist_slots.cu).
#include "hist_tiles.cuh"
#include "wave_member.cuh"

// The direct sweep of f32 values, then its rounding in the same launch:
// every block waits at a grid barrier (`bar`, a counter the caller zeroed;
// the launch is cooperative, so every block is resident) and then rounds
// its share of the f64 sums into out.
template <bool SMEM>
__global__ void __launch_bounds__(LGBT_THREADS)
hist_direct_round_kernel(const uint8_t* __restrict__ X,
                         const float* __restrict__ vals,
                         const int* __restrict__ slot,
                         double* __restrict__ acc, float* __restrict__ out,
                         unsigned* bar, long long N, int F, int C, int K,
                         int B) {
  direct_sweep<float, SMEM>(X, vals, slot, acc, N, F, C, K, B);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (atomicAdd(bar, 0u) < gridDim.x) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
  const long long n = (long long)K * C * F * B;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (float)__ldcg(acc + i);
}

// The direct sweep of f32 values rounded to out in one cooperative launch
// (hist_direct_round_kernel) on the first version's grids, cut to the
// blocks that fit the card at once. acc [K*C*F*B] f64 followed by the
// barrier's counter, all zeroed by the caller.
template <bool SMEM>
static int lgbt_direct_round_launch(const uint8_t* X, const float* vals,
                                    const int* slot, double* acc, float* out,
                                    long long N, int F, int C, int K, int B,
                                    int num_sms, int per_sm, size_t smem,
                                    cudaStream_t st) {
  int fit = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, hist_direct_round_kernel<SMEM>, LGBT_THREADS, smem);
  const int blocks = lgbt_grid(N, num_sms, per_sm < fit ? per_sm : fit);
  unsigned* bar = (unsigned*)(acc + (long long)K * C * F * B);
  void* args[] = {(void*)&X, (void*)&vals, (void*)&slot, (void*)&acc,
                  (void*)&out, (void*)&bar, (void*)&N, (void*)&F,
                  (void*)&C, (void*)&K, (void*)&B};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)hist_direct_round_kernel<SMEM>, dim3(blocks),
      dim3(LGBT_THREADS), args, smem, st);
}

static int lgbt_direct_round_run(const uint8_t* X, const float* vals,
                                 const int* slot, double* acc, float* out,
                                 long long N, int F, int C, int K, int B,
                                 int num_sms, cudaStream_t st) {
  const size_t bytes = (size_t)K * C * F * B * sizeof(double);
  if (K == 1)
    return lgbt_direct_round_launch<true>(X, vals, slot, acc, out, N, F, C,
                                          K, B, num_sms,
                                          lgbt_smem_blocks_per_sm(bytes),
                                          bytes, st);
  return lgbt_direct_round_launch<false>(X, vals, slot, acc, out, N, F, C, K,
                                         B, num_sms, 8, 0, st);
}

// The tiled route over the uniform storage read by Bins.
template <typename Bins>
static void lgbt_wave_tiles(const void* X, const void* vals, int vals_int8,
                            int* slot, void* out, void* acc, long long N,
                            int F, int C, int K, int B, int spt, int fpt,
                            int nst, int nft, int segs, int min_rows,
                            int merge, int pair, int group_warps,
                            cudaStream_t st) {
  Bins bins;
  bins.X = (const uint8_t*)X;
  bins.F = F;
  bins.B = B;
  bins.fpt = fpt;
  const long long n = (long long)K * C * F * B;
  const size_t smem = (size_t)spt * C * fpt * B * (vals_int8 ? 4 : 8);
  if (vals_int8)
    lgbt_tiles_run(bins, (const int8_t*)vals, slot, slot + N, (int*)out,
                   (int*)nullptr, N, C, K, spt, nst, nft, segs, min_rows,
                   merge, 0, group_warps, smem, n, st, true);
  else
    lgbt_tiles_run(bins, (const float*)vals, slot, slot + N, (float*)out,
                   (double*)acc, N, C, K, spt, nst, nft, segs, min_rows,
                   merge, pair && C == 2, group_warps, smem, n, st, true);
}

// X [F, N] uint8, vals [C, N] f32 (vals_int8 = 0) or int8, lor_in /
// lor_out [N] int32, table [16, 128] int32 (wave_table.cuh). out [K, C, F,
// B] f32 or int32; acc (f32 only) f64 [K * C * F * B] sums followed by the
// tiles' completion counters, or on the direct route the grid barrier's
// counter; scratch [N] int32 slots, then the grouping's scratch when
// group_warps > 0. The plan (spt ... group_warps) is kernel #1's
// (hist_slots.cu). The membership pass zeroes the first zero_acc bytes of
// acc and zero_out of out (ops/histogram_cuda.py:wave_hist_layout).
// prefetch > 1: the tiles read a row's bins four columns ahead of its adds
// (UniformBinsAhead), else one (UniformBins, kernel #1's reader). gmap:
// null for leaf_cap <= LGBT_LEAF_CAP (the shared leaf maps), else the
// global maps' [3, leaf_cap] int32 buffer, every word LGBT_GMAP_NONE
// (wave_table.cuh), left so.
extern "C" int lgbt_wave_pass(const void* X, const void* vals, int vals_int8,
                              const void* lor_in, const void* table,
                              void* lor_out, void* out, void* acc,
                              void* scratch, long long N, int F, int C, int K,
                              int B, int leaf_cap, void* gmap, int spt,
                              int fpt, int nst,
                              int nft, int segs, int min_rows, int merge,
                              int pair, int direct, int group_warps,
                              long long zero_acc, long long zero_out,
                              int prefetch, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* slot = (int*)scratch;
  lgbt_wave_member_launch((const uint8_t*)X, (const int*)lor_in,
                          (const int*)table, (int*)lor_out, slot, N, F, K,
                          leaf_cap, (int*)gmap, acc, zero_acc, out, zero_out,
                          num_sms, st);
  if (direct) {
    if (vals_int8) {
      lgbt_direct_run<int8_t>((const uint8_t*)X, (const int8_t*)vals, slot,
                              (int*)out, N, F, C, K, B, num_sms, st, true);
    } else {
      const int rc = lgbt_direct_round_run(
          (const uint8_t*)X, (const float*)vals, slot, (double*)acc,
          (float*)out, N, F, C, K, B, num_sms, st);
      if (rc != 0) return rc;
    }
    return (int)cudaGetLastError();
  }
  if (prefetch > 1)
    lgbt_wave_tiles<UniformBinsAhead<4>>(X, vals, vals_int8, slot, out, acc,
                                         N, F, C, K, B, spt, fpt, nst, nft,
                                         segs, min_rows, merge, pair,
                                         group_warps, st);
  else
    lgbt_wave_tiles<UniformBins>(X, vals, vals_int8, slot, out, acc, N, F,
                                 C, K, B, spt, fpt, nst, nft, segs, min_rows,
                                 merge, pair, group_warps, st);
  return (int)cudaGetLastError();
}
