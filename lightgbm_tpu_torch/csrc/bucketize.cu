// Raw f32 rows -> uint8 bin ids against a packed DeviceBinTable, bitwise
// equal to the host BinMapper (train-mode table) or to
// BinnedModel.bin_rows (serve-mode table).
//
// Replaces lightgbm_tpu/ops/bucketize.py::_bucketize_pallas (pallas_call at
// :351, body _bucketize_kernel / _bin_block). The TPU kernel counts
// bounds with a [R, B] predicate block per feature on the VPU because a
// TPU has no fast gather; it needs the input transposed to [F, n] and
// padded to its (8, 128) tiles. Here each (row, feature) value runs a
// branchless lower-bound search of log2(B) probes (7 at B = 128) into the
// feature's table row in shared memory, the same search as the XLA
// lowering (bucketize.py:407-420).
//
// Per value, the _bin_block rules (bucketize.py:259-292):
//   numeric      cnt = #(floored bound < v), out = min(cnt, clamp);
//                NaN takes nan_bin
//   categorical  key vi = trunc(v); NaN takes nan_key; in serve mode
//                (neg_inv) a negative value takes -2; out = cat_val at the
//                key equal to vi, else miss_bin
// The search compares `probe < q`, false for a NaN probe, so the NaN pads
// of a categorical row act as +inf in the search and never equal a key.
// Equal bounds resolve leftmost, so the count equals the f64
// searchsorted(side="left") of the host. No fast-math and no flush to
// zero: subnormal values and bounds must compare as they are.
//
// Bound: bytes. Each value is read once (4 B) and its bin written once
// (1 B); the table (F*B*8 B, 29 KB at F = 28, B = 128) is read once per
// block into shared memory. Design: persistent blocks stage the table of
// their feature group once, rows padded to B+1 floats so that the
// neighbouring lanes of a warp, which search different features, probe
// different banks; then they walk tiles of LGBT_BK_ROWS rows. A tile
// is read from the row-major [n, ldx] input in flat order (coalesced),
// LGBT_BK_ILP values per thread in flight, binned into a shared [F, R]
// byte tile, and written out in the order of the output's smaller
// stride, so both the feature-major [F, N] X_t of training and the
// row-major [b, F] bins of serving are written with coalesced stores by
// the same kernel. The ragged last tile is masked here; nothing is
// padded.
#include "common.cuh"

#define LGBT_BK_ROWS 128      // rows per tile
#define LGBT_BK_PITCH 132     // bytes per feature row of the shared tile:
                              // the 4-byte skew puts the features of one
                              // row in different banks
#define LGBT_META 8           // meta columns (ops/bucketize.py _META_COLS)
#define LGBT_BK_ILP 4         // values each thread loads before binning

__device__ __forceinline__ unsigned char bin_one(float v,
                                                 const float* __restrict__ tab,
                                                 const float* __restrict__ cv,
                                                 const float* __restrict__ m,
                                                 int B, int top) {
  const bool nan = v != v;
  const bool is_cat = m[0] > 0.0f;
  float q;
  if (is_cat) {
    q = nan ? m[3] : truncf(v);
    if (v < 0.0f && m[5] > 0.0f) q = -2.0f;
  } else {
    if (nan) return (unsigned char)m[2];
    q = v;
  }
  int pos = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int c = min(pos + step, B);
    if (tab[c - 1] < q) pos = c;
  }
  if (is_cat)
    return (pos < B && tab[pos] == q) ? (unsigned char)cv[pos]
                                      : (unsigned char)m[4];
  return (unsigned char)fminf((float)pos, m[1]);
}

__global__ void __launch_bounds__(LGBT_THREADS)
bucketize_kernel(const float* __restrict__ X, long long n, long long ldx,
                 const int* __restrict__ cols, int F,
                 const float* __restrict__ table,
                 const float* __restrict__ cat_val,
                 const float* __restrict__ meta, int B, int top,
                 unsigned char* __restrict__ out, long long s_row,
                 long long s_feat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TP = B + 1;  // shared row pitch of the table and cat_val
  float* s_tab = reinterpret_cast<float*>(smem_raw);
  float* s_cv = s_tab + F * TP;
  float* s_meta = s_cv + F * TP;
  int* s_col = reinterpret_cast<int*>(s_meta + F * LGBT_META);
  unsigned char* s_out = reinterpret_cast<unsigned char*>(s_col + F);

  for (int i = threadIdx.x; i < F * B; i += blockDim.x) {
    const int f = i / B, j = i - f * B;
    s_tab[f * TP + j] = table[i];
    s_cv[f * TP + j] = cat_val[i];
  }
  for (int i = threadIdx.x; i < F * LGBT_META; i += blockDim.x)
    s_meta[i] = meta[i];
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s_col[i] = cols ? cols[i] : i;
  __syncthreads();

  const int R = LGBT_BK_ROWS;
  const int tile = R * F;
  const long long n_tiles = (n + R - 1) / R;
  const bool feat_major = s_row <= s_feat;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * R;
    // LGBT_BK_ILP values per thread in flight: their loads go out
    // together and their searches interleave
    for (int i0 = threadIdx.x; i0 < tile;
         i0 += LGBT_BK_ILP * blockDim.x) {
      float v[LGBT_BK_ILP];
      int rf[LGBT_BK_ILP];
#pragma unroll
      for (int k = 0; k < LGBT_BK_ILP; ++k) {
        const int i = i0 + k * blockDim.x;
        const int r = i / F;
        rf[k] = -1;
        v[k] = 0.0f;
        if (i < tile && r0 + r < n) {
          const int f = i - r * F;
          rf[k] = f * LGBT_BK_PITCH + r;
          v[k] = X[(r0 + r) * ldx + s_col[f]];
        }
      }
#pragma unroll
      for (int k = 0; k < LGBT_BK_ILP; ++k) {
        if (rf[k] >= 0) {
          const int f = rf[k] / LGBT_BK_PITCH;
          s_out[rf[k]] = bin_one(v[k], s_tab + f * TP, s_cv + f * TP,
                                 s_meta + f * LGBT_META, B, top);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      int r, f;
      if (feat_major) {
        f = i / R;
        r = i - f * R;
      } else {
        r = i / F;
        f = i - r * F;
      }
      if (r0 + r < n) out[(r0 + r) * s_row + f * s_feat] =
            s_out[f * LGBT_BK_PITCH + r];
    }
    __syncthreads();
  }
}

// Shared-memory bytes of one launch over F features of a B-lane table
// (ops/bucketize.py _smem_bytes sizes the feature groups with the same sum).
static long long bucketize_smem(int F, int B) {
  return (long long)F * (B + 1) * 8 + (long long)F * LGBT_META * 4 +
         (long long)F * 4 + (long long)F * LGBT_BK_PITCH;
}

extern "C" int lgbt_bucketize(const void* X, long long n, long long ldx,
                              const void* cols, int F, const void* table,
                              const void* cat_val, const void* meta, int B,
                              void* out, long long s_row, long long s_feat,
                              int num_sms, void* stream) {
  const long long smem = bucketize_smem(F, B);
  if (smem > 48 * 1024) {
    cudaError_t a = cudaFuncSetAttribute(
        bucketize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (a != cudaSuccess) return (int)a;
  }
  int top = 1;
  while (top * 2 <= B) top *= 2;
  const long long n_tiles = (n + LGBT_BK_ROWS - 1) / LGBT_BK_ROWS;
  const long long cap = (long long)num_sms * 16;
  const int grid = (int)(n_tiles < 1 ? 1 : (n_tiles < cap ? n_tiles : cap));
  bucketize_kernel<<<grid, LGBT_THREADS, (size_t)smem,
                     (cudaStream_t)stream>>>(
      (const float*)X, n, ldx, (const int*)cols, F, (const float*)table,
      (const float*)cat_val, (const float*)meta, B, top, (unsigned char*)out,
      s_row, s_feat);
  return (int)cudaGetLastError();
}
