// The narrow fused wave: relabel + candidate membership + smaller-child
// slot histogram, then the best-split search of both children of every
// candidate.
//
// Replaces lightgbm_tpu/ops/grow_fused.py::wave_pass_fused_pallas
// (pallas_call at :356): at most 32 storage columns, f32 gradients, the
// 16-row wave table of the megakernel route. On the TPU the scan runs on
// the grid's last step over the accumulator that stays in VMEM. A Hopper
// grid has no last step (blocks run in no order), so the wave is a chain
// of launches:
//   1. the membership pass of kernel #3 (wave_member.cuh): each row's new
//      leaf id and its slot (the candidate whose smaller child it lands
//      in, else -1); it also zeroes what step 2 adds into;
//   2. the smaller children's slot histogram by the tiled engine of
//      hist_tiles.cuh on kernel #1's plan (rows grouped by slot at K > 1,
//      (slot, feature) tiles of <= 48 KB, the tiles' last blocks rounding
//      to f32, a row's bins read ahead as in kernel #3), or for little
//      work the direct sweep, whose f64 sums the scan rounds;
//   3. the scan of every child (split_scan.cuh), a warp per (child,
//      feature).
// Steps 2 and 3 are the tail shared with kernel #10 (fused_tail.cuh).
//
// Bound: bytes. A row reads its leaf id and at most two bin bytes and
// writes its leaf id and slot; a row of a smaller child also reads its F
// bins and 2 values; the parent histograms (K * 2 * F * B f32) are read
// once by the scan, which is a few operations per histogram cell.
#include "fused_tail.cuh"
#include "wave_member.cuh"

// X [F, N] uint8, vals [2, N] f32, lor_in / lor_out [N] int32, table [16,
// 128] int32 (wave_table.cuh), out [K, 2, F, B] f32 written here, acc f64
// ([K * 2 * F * B] sums, then the tiles' completion counters), scratch [N]
// int32 slots then the grouping's scratch when group_warps > 0; the plan
// (spt ... group_warps) is kernel #1's (hist_slots.cu). The membership
// pass zeroes the first zero_acc bytes of acc and zero_out of out
// (ops/histogram_cuda.py:wave_hist_layout); prefetch as lgbt_wave_pass's
// (wave_pass.cu). parent [K, 2, F, B] f32; scal
// / fmeta / fmask / rec as lgbt_split_scan_kernel, scan_scratch its [2K]
// keys and [2K] counters. gmap as lgbt_wave_pass's (wave_pass.cu).
extern "C" int lgbt_wave_pass_fused(
    const void* X, const void* vals, const void* lor_in, const void* table,
    void* lor_out, void* out, void* acc, void* scratch, const void* parent,
    const void* scal, const void* fmeta, const void* fmask,
    int fmask_stride, void* rec, void* scan_scratch, long long N, int F,
    int K, int B, int leaf_cap, void* gmap, int spt, int fpt, int nst,
    int nft,
    int segs, int min_rows, int merge, int pair, int direct,
    int group_warps, long long zero_acc, long long zero_out, int prefetch,
    float min_data_slack, float min_hess, float l1, float l2,
    float max_delta_step, float path_smooth, float min_gain, int use_mds,
    int use_ps, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* slot = (int*)scratch;
  lgbt_wave_member_launch((const uint8_t*)X, (const int*)lor_in,
                          (const int*)table, (int*)lor_out, slot, N, F, K,
                          leaf_cap, (int*)gmap, acc, zero_acc, out, zero_out,
                          num_sms, st);
  const LgbtSplitHp hp =
      lgbt_make_hp(min_data_slack, min_hess, l1, l2, max_delta_step,
                   path_smooth, min_gain, use_mds, use_ps);
  const LgbtTilePlan p = {spt,  fpt,   nst,  nft,    segs,
                          min_rows, merge, pair, direct, group_warps};
  auto tail = [&](auto bins) {
    lgbt_fused_hist_scan<float, decltype(bins)>(
        (const uint8_t*)X, (const float*)vals, slot, slot + N, (float*)out,
        (double*)acc, (const float*)parent, (const float*)scal,
        (const int*)fmeta, (const uint8_t*)fmask, fmask_stride, (float*)rec,
        scan_scratch, N, F, K, B, p, true, nullptr, hp, num_sms, st);
  };
  if (prefetch > 1)
    tail(UniformBinsAhead<4>());
  else
    tail(UniformBins());
  return (int)cudaGetLastError();
}
