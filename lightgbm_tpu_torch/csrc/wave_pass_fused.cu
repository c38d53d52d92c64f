// The narrow fused wave: relabel + candidate membership + smaller-child
// slot histogram in one row sweep, then the best-split search of both
// children of every candidate.
//
// Replaces lightgbm_tpu/ops/grow_fused.py::wave_pass_fused_pallas
// (pallas_call at :356): at most 32 storage columns, f32 gradients, the
// 16-row wave table of the megakernel route. On the TPU the scan runs on
// the grid's last step over the accumulator that stays in VMEM. A Hopper
// grid has no last step (blocks run in no order), so this is design (c) of
// the port's notes: a histogram launch, then a scan launch. Per wave:
//   1. wave_pass_kernel (wave_pass.cuh), the row sweep of wave_pass.cu:
//      f64 accumulators, in shared memory when they fit;
//   2. lgbt_split_scan_kernel (split_scan.cuh): a warp per (child,
//      feature) reads the f64 sums (small, or parent - small) as their f32
//      rounding, and the warps of the left children write that rounding
//      to `out`, the histogram the next wave's parent-minus-sibling reads;
//      each child's last block writes its SplitResult record.
// Two launches and a memset of the scan's keys; the histogram goes to
// device memory once (it must: the grower caches it), and the f64 sums come
// back from L2 for the scan.
//
// Bound: bytes for the row sweep (as wave_pass.cu: leaf ids in and out,
// the split features' bins, the smaller children's rows), plus the parent
// histograms (K * 2 * F * B f32) the scan reads; the scan itself is a few
// operations per histogram cell.
#include "split_scan.cuh"
#include "wave_pass.cuh"

// X [F, N] uint8, vals [2, N] f32, lor_in / lor_out [N] int32, table [16,
// 128] int32 (wave_table.cuh), out [K, 2, F, B] f32 written here, acc
// [K * 2 * F * B] f64 zeroed by the caller, parent [K, 2, F, B] f32, scal /
// fmeta / fmask / rec as lgbt_split_scan_kernel, scan_scratch its [2K]
// keys and [2K] counters.
extern "C" int lgbt_wave_pass_fused(
    const void* X, const void* vals, const void* lor_in, const void* table,
    void* lor_out, void* out, void* acc, const void* parent, const void* scal,
    const void* fmeta, const void* fmask, int fmask_stride, void* rec,
    void* scan_scratch, long long N, int F, int K, int B, int leaf_cap,
    float min_data_slack, float min_hess, float l1, float l2,
    float max_delta_step, float path_smooth, float min_gain, int use_mds,
    int use_ps, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int C = 2;
  lgbt_wave_pass_launch<float>((const uint8_t*)X, (const float*)vals,
                               (const int*)lor_in, (const int*)table,
                               (int*)lor_out, (double*)acc, N, F, C, K, B,
                               leaf_cap, num_sms, st);
  const LgbtSplitHp hp =
      lgbt_make_hp(min_data_slack, min_hess, l1, l2, max_delta_step,
                   path_smooth, min_gain, use_mds, use_ps);
  lgbt_split_scan_launch<double, float>(
      (const double*)acc, (const float*)parent, (float*)out,
      (const float*)scal, (const int*)fmeta, (const uint8_t*)fmask,
      fmask_stride, (float*)rec, scan_scratch, K, F, B, 1.0f, 1.0f, hp, st);
  return (int)cudaGetLastError();
}
