// Raw f32 rows of many tenants -> uint8 bin ids, each row against its own
// tenant's serve-mode bin table: the fleet's fused cross-tenant drain
// (export/fusion.py), one launch for a mixed batch.
//
// Replaces lightgbm_tpu/ops/bucketize.py::bucketize_rows_stacked (:448),
// which is XLA there (a gather of each row's tenant table, then #6's
// _bin_block predicates), not a Pallas kernel. It keeps the mixed batch in
// one launch, as the JAX program keeps it inside the fused walk's.
//
// The stacked table (ops/bucketize.py stack_bin_tables, upload_stacked):
// C tenants' tables re-padded to a common F and B, row c * F + f the table
// of tenant c's feature f, with its meta row and its bucket grid (NB
// buckets, as upload_bin_table builds for #6). Columns past a tenant's own
// features are inert rows (+inf bounds, clamp 0): bin 0. Each value takes
// #6's rules (csrc/bucketize.cu, bucketize.py:259-292 of the JAX package):
//   numeric      cnt = #(floored bound < v), out = min(cnt, clamp); NaN
//                takes nan_bin
//   categorical  key vi = trunc(v); NaN takes nan_key; a negative value
//                takes -2 (serve mode); out = cat_val at the key equal to
//                vi, else miss_bin
// through #6's search: the key's grid bucket, then `depth` lower-bound
// probes among that bucket's bounds (equal bounds resolve leftmost), so a
// tenant's bins are bitwise those of #6 on its own table.
//
// Bound: bytes. Each value is read once (4 B) and its bin written once
// (1 B); the tables (C * F rows of B lanes, a few hundred KB) stay in L2.
// #6's design (one feature group's tables staged in shared memory per
// block) does not carry over: every row of a mixed batch has another
// table. Design: a warp per row, a lane per feature (32 features a pass),
// so the row's values are read and its bins written coalesced; each lane
// reads its (tenant, feature) meta row, grid and probes from global memory
// through the read-only path. A served batch is at most a few thousand
// rows, so the grid is one block of 8 warps per 8 rows, up to the card's
// resident blocks, and the warps stride over the rows.
#include "common.cuh"

#define LGBT_BS_META 8          // meta columns (_META_COLS)
#define LGBT_BS_GRID_HEAD 2     // lo, scale before the buckets

__device__ __forceinline__ unsigned char bs_bin(
    float v, const float* __restrict__ m, const int* __restrict__ grid,
    int nb, const float* __restrict__ tab, const float* __restrict__ cv) {
  const bool is_cat = __ldg(m + 0) > 0.0f;
  float q = v;
  if (is_cat) {
    q = v != v ? __ldg(m + 3) : truncf(v);
    if (v < 0.0f && __ldg(m + 5) > 0.0f) q = -2.0f;
  }
  // the key's bucket of the row's grid: bounds [first, end) packed
  // first | end << 16 (a NaN numeric key lands in bucket 0)
  const float lo = __int_as_float(__ldg(grid + 0));
  const float scale = __int_as_float(__ldg(grid + 1));
  float t = __fmul_rn(__fsub_rn(q, lo), scale);
  t = fminf(fmaxf(floorf(t), 0.0f), (float)(nb - 1));
  const int g = __ldg(grid + LGBT_BS_GRID_HEAD + (int)t);
  int p = g & 0xFFFF;
  const int e = g >> 16;
  const int depth = (int)__ldg(m + 6);
  for (int step = depth > 0 ? 1 << (depth - 1) : 0; step > 0; step >>= 1) {
    const int c = min(p + step, e);
    if (__ldg(tab + max(c - 1, p)) < q) p = c;
  }
  if (is_cat) {
    const int count = (int)__ldg(m + 7);
    return (p < count && __ldg(tab + p) == q) ? (unsigned char)__ldg(cv + p)
                                              : (unsigned char)__ldg(m + 4);
  }
  if (v != v) return (unsigned char)__ldg(m + 2);
  return (unsigned char)fminf((float)p, __ldg(m + 1));
}

__global__ void __launch_bounds__(LGBT_THREADS)
bucketize_stacked_kernel(const float* __restrict__ X, long long n,
                         long long ldx, const int* __restrict__ tid, int C,
                         int F, const float* __restrict__ table,
                         const int* __restrict__ grids, int NB,
                         const float* __restrict__ cat_val,
                         const float* __restrict__ meta, int B,
                         unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (LGBT_THREADS / 32);
  const int GP = LGBT_BS_GRID_HEAD + NB;
  for (long long r = (long long)blockIdx.x * (LGBT_THREADS / 32) +
                     (threadIdx.x >> 5);
       r < n; r += warps) {
    const int c = __ldg(tid + r);
    const bool ok = c >= 0 && c < C;
    for (int f = lane; f < F; f += 32) {
      unsigned char b = 0;
      if (ok) {
        const long long row = (long long)c * F + f;
        b = bs_bin(X[r * ldx + f], meta + row * LGBT_BS_META,
                   grids + row * GP, NB, table + row * B,
                   cat_val + row * B);
      }
      out[r * F + f] = b;
    }
  }
}

// One launch over n rows of F features: X [n, >= F] f32 with row stride
// ldx, tid [n] int32 (a row whose tenant id is outside [0, C) bins to 0),
// table and cat_val [C * F, B], grids [C * F, 2 + NB] int32, meta
// [C * F, 8]; out [n, F] uint8, row-major.
extern "C" int lgbt_bucketize_stacked(const void* X, long long n,
                                      long long ldx, const void* tid, int C,
                                      int F, const void* table,
                                      const void* grids, int NB,
                                      const void* cat_val, const void* meta,
                                      int B, void* out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucketize_stacked_kernel, LGBT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long rows_per_block = LGBT_THREADS / 32;
  long long grid = (n + rows_per_block - 1) / rows_per_block;
  const long long fit = (long long)per_sm * sms;
  if (fit >= 1 && grid > fit) grid = fit;
  if (grid < 1) grid = 1;
  bucketize_stacked_kernel<<<(int)grid, LGBT_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const float*)X, n, ldx, (const int*)tid, C, F, (const float*)table,
      (const int*)grids, NB, (const float*)cat_val, (const float*)meta, B,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}
