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
// Past 256 bins a column the storage is uint16 (the JAX package's XLA
// lowering covers it there, ops/histogram.py:227); the same engine reads it
// through its bin reader (UniformBinsOf<uint16_t>), and where one column's
// bins exceed a tile's budget a tile holds a range of them. A caller may
// also pass the rows as a window of an id list in device memory (the
// compact grower's leaf, ops/grow_batched.py): a fixed grid planned for N
// rows whose blocks past the window's pieces exit at once.
//
// -Xptxas -v (sm_90a, nvcc 12.8): chip_smoke.py's device line prints the
// registers, spills and static shared memory of every entry function of
// every build; PERF.md keeps this source's.
#include "hist_tiles.cuh"

// The tiled sweep over the uniform storage of bin type T (CUT: bin-range
// tiles, nft = F * nbt of bpt bins).
template <typename T, bool CUT>
static void hist_tiles_for(const void* X, const void* vals, int vals_int8,
                           const int* slot, const int* rows, const int* win,
                           int* scratch, void* out, void* acc, long long N,
                           int F, int C, int K, int B, int spt, int fpt,
                           int nst, int nft, int bpt, int segs, int min_rows,
                           int merge, int pair, int group_warps, long long n,
                           cudaStream_t st) {
  UniformBinsOf<T, CUT> bins;
  bins.X = (const T*)X;
  bins.F = F;
  bins.B = B;
  bins.fpt = fpt;
  bins.nbt = CUT ? nft / F : 1;
  bins.bpt = bpt;
  const size_t smem =
      (size_t)spt * C * (CUT ? bpt : fpt * B) * (vals_int8 ? 4 : 8);
  if (vals_int8)
    lgbt_tiles_run(bins, (const int8_t*)vals, slot, scratch, (int*)out,
                   (int*)nullptr, N, C, K, spt, nst, nft, segs, min_rows,
                   merge, 0, group_warps, smem, n, st, false, rows, win);
  else
    lgbt_tiles_run(bins, (const float*)vals, slot, scratch, (float*)out,
                   (double*)acc, N, C, K, spt, nst, nft, segs, min_rows,
                   merge, pair && C == 2, group_warps, smem, n, st, false,
                   rows, win);
}

template <typename T>
static void hist_direct_for(const void* X, const void* vals, int vals_int8,
                            const int* slot, void* out, void* acc,
                            long long N, int F, int C, int K, int B,
                            long long n, int num_sms, cudaStream_t st) {
  if (vals_int8) {
    lgbt_direct_run<int8_t>((const T*)X, (const int8_t*)vals, slot,
                            (int*)out, N, F, C, K, B, num_sms, st);
  } else {
    lgbt_direct_run<float>((const T*)X, (const float*)vals, slot,
                           (double*)acc, N, F, C, K, B, num_sms, st);
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
  }
}

// The tile plan (spt, fpt, nst, nft, bpt, segs, min_rows, merge, pair,
// direct) comes from plan_hist_tiles / hist_segments in
// ops/histogram_cuda.py. X is [F, N] uint8, or uint16 with bin16 = 1; bpt
// < B (uint16 only) cuts each column's bins into nft / F tiles of bpt bins
// (fpt = 1).
// direct = 1: the direct sweep (acc as below, zeroed here; the tile fields
// unused; at K = 1 a block's private histogram in shared memory, within
// HIST_SMEM_BUDGET), then the rounding to f32, on the first version's grids
// for num_sms SMs.
// vals_int8 = 0: vals f32, out f32; acc is [K*C*F*B] f64 followed by
// nst*nft unsigned completion counters when a tile may take several pieces
// (grouped rows, a window, or segs > 1), else unused. vals_int8 = 1: vals
// int8, out int32, the accumulators themselves (acc unused). What the
// blocks add into is zeroed here, and with grouped rows or a window the
// output too (a slot tile without rows takes no block). slot may be null
// (every row in slot 0).
// group_warps > 0 (slot given): the rows are grouped by slot first, and
// scratch holds [K*W wcnt | K totals | K+1 offsets | N row ids] int32,
// W = group_warps.
// rows != null (slot null, K = 1, group_warps = 0): the window, the rows
// rows[win[0] .. win[1]) of an int32 id list, win [2] int32 in device
// memory; segs is the pieces of a grouped launch over N rows.
extern "C" int lgbt_hist_slots(const void* X, int bin16, const void* vals,
                               int vals_int8, const void* slot,
                               const void* rows, const void* win,
                               void* scratch, void* out, void* acc,
                               long long N, int F, int C, int K, int B,
                               int spt, int fpt, int nst, int nft, int bpt,
                               int segs, int min_rows, int merge, int pair,
                               int direct, int group_warps, int num_sms,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)K * C * F * B;
  const int* sl = (const int*)slot;
  if (direct) {
    if (bin16)
      hist_direct_for<uint16_t>(X, vals, vals_int8, sl, out, acc, N, F, C,
                                K, B, n, num_sms, st);
    else
      hist_direct_for<uint8_t>(X, vals, vals_int8, sl, out, acc, N, F, C, K,
                               B, n, num_sms, st);
    return (int)cudaGetLastError();
  }
  const int* rw = (const int*)rows;
  const int* wn = (const int*)win;
  int* sc = (int*)scratch;
  if (bin16 && bpt < B)
    hist_tiles_for<uint16_t, true>(X, vals, vals_int8, sl, rw, wn, sc, out,
                                   acc, N, F, C, K, B, spt, fpt, nst, nft,
                                   bpt, segs, min_rows, merge, pair,
                                   group_warps, n, st);
  else if (bin16)
    hist_tiles_for<uint16_t, false>(X, vals, vals_int8, sl, rw, wn, sc, out,
                                    acc, N, F, C, K, B, spt, fpt, nst, nft,
                                    bpt, segs, min_rows, merge, pair,
                                    group_warps, n, st);
  else
    hist_tiles_for<uint8_t, false>(X, vals, vals_int8, sl, rw, wn, sc, out,
                                   acc, N, F, C, K, B, spt, fpt, nst, nft,
                                   bpt, segs, min_rows, merge, pair,
                                   group_warps, n, st);
  return (int)cudaGetLastError();
}
