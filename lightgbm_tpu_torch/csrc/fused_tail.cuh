// The histogram-and-scan tail of the two fused wave kernels, #9
// (wave_pass_fused.cu) and #10 (wave_pass_fused_tiled.cu): after their
// membership passes have written each row's slot, the smaller children's
// slot histogram over the uniform [F, N] storage by the tiled engine of
// hist_tiles.cuh (or its direct route, for little work), then the scan of
// every child (split_scan.cuh):
//   int8 values  the engine's int32 sums are `out`; the scan subtracts
//                parent - small in int32 and descales;
//   direct       the f64 sums stay in acc, and the scan's left-child warps
//                write their f32 rounding to `out` as they read them;
//   tiled        the tiles' last blocks round to f32 in `out`, which the
//                scan reads.
#pragma once

#include "hist_tiles.cuh"
#include "split_scan.cuh"

// The engine's launch shape, from ops/histogram_cuda.py (plan_hist_tiles,
// tile_sizes): tiles of spt slots x fpt features, nst x nft of them, segs
// row pieces, min_rows rows a piece at least, the warp merge, the channel
// pairing, the direct route, group_warps grouping warps (0: rows not
// grouped).
struct LgbtTilePlan {
  int spt, fpt, nst, nft, segs, min_rows, merge, pair, direct, group_warps;
};

// X [F, N] uint8, vals [2, N] f32 or int8, slot [N] int32 (-1: no slot),
// group_scratch the grouping's scratch (lgbt_group_rows), out [K, 2, F, B]
// f32 or int32, acc the f32 path's f64 sums and tile counters, parent [K,
// 2, F, B] f32 or int32; scal / fmeta / fmask / rec / scan_scratch as
// lgbt_split_scan_kernel, scale its [2] f32 descale factors of int32 sums
// (null for f32 sums). `zeroed`: the caller zeroed what the histogram
// adds into (else it is zeroed here). Bins: the engine's reader of the
// uniform storage (UniformBins, or UniformBinsAhead).
template <typename V, typename Bins = UniformBins>
static void lgbt_fused_hist_scan(
    const uint8_t* X, const V* vals, const int* slot, int* group_scratch,
    typename OutOf<V>::T* out, double* acc,
    const typename OutOf<V>::T* parent, const float* scal, const int* fmeta,
    const uint8_t* fmask, int fmask_stride, float* rec, void* scan_scratch,
    long long N, int F, int K, int B, const LgbtTilePlan& p, bool zeroed,
    const float* scale, const LgbtSplitHp& hp, int num_sms,
    cudaStream_t st) {
  typedef typename OutOf<V>::T O;
  const int C = 2;
  const long long n = (long long)K * C * F * B;
  const bool quant = !OutOf<V>::kRound;
  if (p.direct) {
    if constexpr (OutOf<V>::kRound) {
      // the scan reads the f64 sums and writes their f32 rounding to out
      lgbt_direct_run<float>(X, vals, slot, acc, N, F, C, K, B, num_sms, st,
                             zeroed);
      lgbt_split_scan_launch<double, float>(
          acc, parent, out, scal, fmeta, fmask, fmask_stride, rec,
          scan_scratch, K, F, B, nullptr, hp, st);
      return;
    } else {
      lgbt_direct_run<int8_t>(X, vals, slot, out, N, F, C, K, B, num_sms, st,
                              zeroed);
    }
  } else {
    Bins bins;
    bins.X = X;
    bins.F = F;
    bins.B = B;
    bins.fpt = p.fpt;
    const size_t smem = (size_t)p.spt * C * p.fpt * B * (quant ? 4 : 8);
    lgbt_tiles_run(bins, vals, slot, group_scratch, out,
                   (typename AccOf<V>::T*)(quant ? nullptr : (void*)acc), N,
                   C, K, p.spt, p.nst, p.nft, p.segs, p.min_rows, p.merge,
                   quant ? 0 : p.pair, p.group_warps, smem, n, st, zeroed);
  }
  lgbt_split_scan_launch<O, O>(out, parent, nullptr, scal, fmeta, fmask,
                               fmask_stride, rec, scan_scratch, K, F, B,
                               scale, hp, st);
}
