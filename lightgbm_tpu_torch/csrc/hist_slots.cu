// K-slot histogram: hist[k, c, f, b] = sum_r vals[c, r] * [slot[r] == k] *
// [X[f, r] == b]; rows whose slot is outside [0, K) add nothing.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::build_histogram_slots_pallas
// (pallas_call at :280) and its K=1 wrapper build_histogram_pallas (:742).
// The TPU kernel builds a one-hot of the bins in VMEM and contracts it on
// the MXU, because a TPU has no atomics. On Hopper the direct form is a
// scatter-add: each row reads its slot and its F bins and adds its C values.
//
// Bound: bytes (each row's F bin bytes, C value words and slot word read
// once, the output written once). The first version, a row per thread
// into a privatised whole histogram or global f64 atomics, reached 1/22 to
// 1/150 of the byte bound, bounded by the shared f64 compare-and-swap loop
// (atomicAdd(double*) on sm_90a). The sweep is the tiled accumulation
// engine of hist_tiles.cuh over the uniform [F, N] storage (UniformBins):
// (slot, feature) tiles of <= 48 KB, rows grouped by slot, pieces balanced
// by rows, the warp merge at B > 64, the 128-bit channel pairing at K = 1,
// the direct route for little work, and the flush that rounds to f32 in
// the tile's last block. The planner (plan_hist_tiles in
// ops/histogram_cuda.py) sizes every launch; times in PERF.md, from
// scripts/hist_slots_bench.py on an H100 80GB HBM3 at 700 W.
//
// -Xptxas -v (sm_90a, nvcc 12.8): chip_smoke.py's device line prints the
// registers, spills and static shared memory of every entry function of
// every build; PERF.md keeps this source's.
#include "hist_tiles.cuh"

// The tile plan (spt, fpt, nst, nft, segs, min_rows, merge, pair, direct)
// comes from plan_hist_tiles / hist_segments in ops/histogram_cuda.py.
// direct = 1: the direct sweep (acc as below, zeroed here; the tile fields
// unused; at K = 1 a block's private histogram in shared memory, within
// HIST_SMEM_BUDGET), then the rounding to f32, on the first version's grids
// for num_sms SMs.
// vals_int8 = 0: vals f32, out f32; acc is [K*C*F*B] f64 followed by
// nst*nft unsigned completion counters when a tile may take several pieces
// (grouped rows, or segs > 1), else unused. vals_int8 = 1: vals int8, out
// int32, the accumulators themselves (acc unused). What the blocks add
// into is zeroed here, and with grouped rows the output too (a slot tile
// without rows takes no block). slot may be null (every row in slot 0).
// group_warps > 0 (slot given): the rows are grouped by slot first, and
// scratch holds [K*W wcnt | K totals | K+1 offsets | N row ids] int32,
// W = group_warps.
extern "C" int lgbt_hist_slots(const void* X, const void* vals, int vals_int8,
                               const void* slot, void* scratch, void* out,
                               void* acc, long long N, int F, int C, int K,
                               int B, int spt, int fpt, int nst, int nft,
                               int segs, int min_rows, int merge, int pair,
                               int direct, int group_warps, int num_sms,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)K * C * F * B;
  if (direct) {
    if (vals_int8) {
      lgbt_direct_run<int8_t>((const uint8_t*)X, (const int8_t*)vals,
                              (const int*)slot, (int*)out, N, F, C, K, B,
                              num_sms, st);
    } else {
      lgbt_direct_run<float>((const uint8_t*)X, (const float*)vals,
                             (const int*)slot, (double*)acc, N, F, C, K, B,
                             num_sms, st);
      acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
          (const double*)acc, (float*)out, n);
    }
    return (int)cudaGetLastError();
  }
  UniformBins bins;
  bins.X = (const uint8_t*)X;
  bins.F = F;
  bins.B = B;
  bins.fpt = fpt;
  const size_t smem = (size_t)spt * C * fpt * B * (vals_int8 ? 4 : 8);
  if (vals_int8)
    lgbt_tiles_run(bins, (const int8_t*)vals, (const int*)slot,
                      (int*)scratch, (int*)out, (int*)nullptr, N, C, K, spt,
                      nst, nft, segs, min_rows, merge, 0, group_warps, smem,
                      n, st);
  else
    lgbt_tiles_run(bins, (const float*)vals, (const int*)slot,
                      (int*)scratch, (float*)out, (double*)acc, N, C, K, spt,
                      nst, nft, segs, min_rows, merge, pair && C == 2,
                      group_warps, smem, n, st);
  return (int)cudaGetLastError();
}
