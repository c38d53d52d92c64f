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
// form is a scatter-add of each row's values into its columns' cells.
//
// Bound: bytes. Each row is read once (F bin bytes, or about half of that
// for nibble-packed columns, C value words and one slot word); the flat
// output is written once. The first version walked all F columns of a row
// per thread into a privatised copy of the whole K * C * total buffer (one
// block per SM at the Criteo root) or, past the shared-memory opt-in,
// into global f64 accumulators in L2: 1.1-1.3 ms at Criteo K = 1 / 16 /
// 128 (PERF.md). The sweep is now the tiled accumulation engine of
// hist_tiles.cuh with the flat reader (FlatBins): tiles of column ranges
// whose cells fit 48 KB (plan_flat_tiles in ops/histogram_cuda.py), rows
// grouped by slot, pieces balanced by rows, the warp merge on every column
// where one is wider than 64 (merging by each column's width left the
// narrow Zipf categorical columns' compare-and-swaps serialised: 1.25x
// slower at the Criteo root, PERF.md), the channel pairing at K = 1
// without it, and the f32 rounding in each tile's last block. Both entry
// points share the reader: a column's descriptor names its byte row and,
// packed, the nibble of its bits. Float channels accumulate in f64 and are
// rounded once, so the flat buffer equals the col-wise histogram bit for
// bit after expansion; int8 channels accumulate exactly in int32.
#include "hist_tiles.cuh"

// X / Xu and desc as FlatBins (hist_tiles.cuh): desc [4, F] int32 rows
// offset, width, nibble index (-1: a whole byte), byte row, then the tile
// cuts [nft + 1]. The plan (spt, nst, nft, max_cols, segs, min_rows,
// merge, pair, smem) comes from plan_flat_tiles / hist_segments in
// ops/histogram_cuda.py. Output, accumulator, scratch and slot conventions
// as lgbt_hist_slots (hist_slots.cu), over the flat [K, C, total] buffer.
template <bool PACKED>
static int run(const void* X, const void* Xu, const void* vals,
               int vals_int8, const void* slot, const void* desc,
               void* scratch, void* out, void* acc, long long N, int F,
               int C, int K, int total, int spt, int nst, int nft,
               int max_cols, int segs, int min_rows, int merge, int pair,
               int group_warps, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FlatBins<PACKED> bins;
  bins.X = (const uint8_t*)X;
  bins.Xu = (const uint8_t*)Xu;
  bins.desc = (const int*)desc;
  bins.N = N;
  bins.F = F;
  bins.total = total;
  bins.max_cols = max_cols;
  bins.sc = nullptr;
  const long long n = (long long)K * C * total;
  if (vals_int8)
    lgbt_tiles_run(bins, (const int8_t*)vals, (const int*)slot,
                      (int*)scratch, (int*)out, (int*)nullptr, N, C, K, spt,
                      nst, nft, segs, min_rows, merge, 0, group_warps,
                      (size_t)smem, n, st);
  else
    lgbt_tiles_run(bins, (const float*)vals, (const int*)slot,
                      (int*)scratch, (float*)out, (double*)acc, N, C, K, spt,
                      nst, nft, segs, min_rows, merge, pair && C == 2,
                      group_warps, (size_t)smem, n, st);
  return (int)cudaGetLastError();
}

// X [F, N] uint8 storage; desc's nibble row all -1 and byte row f.
extern "C" int lgbt_hist_rowwise(const void* X, const void* vals,
                                 int vals_int8, const void* slot,
                                 const void* desc, void* scratch, void* out,
                                 void* acc, long long N, int F, int C, int K,
                                 int total, int spt, int nst, int nft,
                                 int max_cols, int segs, int min_rows,
                                 int merge, int pair, int group_warps,
                                 int smem, void* stream) {
  return run<false>(X, nullptr, vals, vals_int8, slot, desc, scratch, out,
                    acc, N, F, C, K, total, spt, nst, nft, max_cols, segs,
                    min_rows, merge, pair, group_warps, smem, stream);
}

// Xp [ceil(P / 2), N] nibble-packed bytes, Xu [max(F - P, 1), N] remainder;
// desc's rows 2-3 the nibble index (or -1) and remainder row of each
// column. Everything else as lgbt_hist_rowwise.
extern "C" int lgbt_hist_rowwise_packed(
    const void* Xp, const void* Xu, const void* vals, int vals_int8,
    const void* slot, const void* desc, void* scratch, void* out, void* acc,
    long long N, int F, int C, int K, int total, int spt, int nst, int nft,
    int max_cols, int segs, int min_rows, int merge, int pair,
    int group_warps, int smem, void* stream) {
  return run<true>(Xp, Xu, vals, vals_int8, slot, desc, scratch, out, acc,
                   N, F, C, K, total, spt, nst, nft, max_cols, segs,
                   min_rows, merge, pair, group_warps, smem, stream);
}
