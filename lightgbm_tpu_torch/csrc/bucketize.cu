// Raw f32 rows -> uint8 bin ids against a packed DeviceBinTable, bitwise
// equal to the host BinMapper (train-mode table) or to
// BinnedModel.bin_rows (serve-mode table).
//
// Replaces lightgbm_tpu/ops/bucketize.py::_bucketize_pallas (pallas_call at
// :351, body _bucketize_kernel / _bin_block). The TPU kernel counts
// bounds with a [R, B] predicate block per feature on the VPU because a
// TPU has no fast gather; it needs the input transposed to [F, n] and
// padded to its (8, 128) tiles. Here each value finds its count of bounds
// through a per-feature grid in shared memory and a short search.
//
// Per value, the _bin_block rules (bucketize.py:259-292):
//   numeric      cnt = #(floored bound < v), out = min(cnt, clamp);
//                NaN takes nan_bin
//   categorical  key vi = trunc(v); NaN takes nan_key; in serve mode
//                (neg_inv) a negative value takes -2; out = cat_val at the
//                key equal to vi, else miss_bin
//
// The search (ops/bucketize.py search_grids builds its tables). A table
// row is sorted: its `count` searchable lanes (meta column 7), then +inf
// (numeric) or NaN (categorical) pads that no key is above. Each row
// carries a grid of NB buckets over its bounds' range, bucket(x) =
// clamp(floor((x - lo) * scale), 0, NB - 1) in f32 with round-to-nearest
// (never contracted, no flush to zero), evaluated the same way on the
// host for the bounds. The function is monotone, so every bound of a
// lower bucket than the key's is below the key and every bound of a
// higher one above it: the count is the first bound of the key's bucket
// plus a lower-bound search among that bucket's bounds, `depth` probes
// (meta column 6: enough for the row's largest bucket). A row whose
// bounds span no finite range has scale 0 and one bucket, the whole row.
// Equal bounds resolve leftmost, so the count equals the f64
// searchsorted(side="left") of the host, and a categorical key is present
// iff the lane at its count equals it.
//
// Bound: bytes. Each value is read once (4 B) and its bin written once
// (1 B); the tables are read once per resident block. Design:
//  * The grid of blocks is (feature group x row tiles). A block bins the
//    features of one group (at most 32, one lane each) and stages that
//    group's rows, grids, cat_val bytes and meta once, then walks its row
//    tiles persistently; the launch holds the blocks that fit (the planner
//    in ops/bucketize.py, then the registers' occupancy), and small inputs
//    (served chunks) are cut into more, narrower groups so that they
//    spread over several blocks.
//  * A tile of 128 rows is read row by row (a warp per row, a lane per
//    feature: coalesced over the row) into a feature-major value tile.
//    The next tile's values are loaded into registers before this tile's
//    search, so the loads overlap the search and the stores.
//  * The search runs a warp per feature of the tile, four rows a lane
//    whose probes interleave, so a feature's scalars are read once per
//    128 values; no division per value.
//  * Stores: the feature-major [F, N] X_t of training as 4-byte words per
//    lane (128 rows of one feature per warp) where the layout is 4-byte
//    aligned, the row-major [b, F] bins of serving a row per warp; the
//    ragged last tile is masked here and nothing is padded.
#include "common.cuh"

#define LGBT_BK_ROWS 128                  // rows per tile
#define LGBT_BK_WARPS (LGBT_THREADS / 32)
#define LGBT_BK_RPW (LGBT_BK_ROWS / LGBT_BK_WARPS)  // rows a warp loads
#define LGBT_BK_XP (LGBT_BK_ROWS + 1)     // value tile pitch (floats)
#define LGBT_BK_OP (LGBT_BK_ROWS + 4)     // bin tile pitch (bytes)
#define LGBT_META 8                       // meta columns (_META_COLS)
#define LGBT_BK_GRID_HEAD 2               // lo, scale before the buckets

struct BkFeature {
  float clamp, nan_bin, nan_key, miss_bin, lo, scale;
  int is_cat, neg_inv, depth, count;
};

__device__ __forceinline__ BkFeature bk_feature(const float* m,
                                                const int* grid) {
  BkFeature f;
  f.is_cat = m[0] > 0.0f;
  f.clamp = m[1];
  f.nan_bin = m[2];
  f.nan_key = m[3];
  f.miss_bin = m[4];
  f.neg_inv = m[5] > 0.0f;
  f.depth = (int)m[6];
  f.count = (int)m[7];
  f.lo = __int_as_float(grid[0]);
  f.scale = __int_as_float(grid[1]);
  return f;
}

// the search key of value v: v itself for a numeric feature (a NaN
// lands in bucket 0 and bk_out gives it nan_bin), the categorical key
// otherwise
__device__ __forceinline__ float bk_query(float v, const BkFeature& m) {
  if (!m.is_cat) return v;
  float q = v != v ? m.nan_key : truncf(v);
  if (v < 0.0f && m.neg_inv) q = -2.0f;
  return q;
}

// the key's bucket: its bounds [first, end), packed first | end << 16
__device__ __forceinline__ int bk_bucket(float q, const BkFeature& m,
                                         int nb, const int* buckets) {
  float t = __fmul_rn(__fsub_rn(q, m.lo), m.scale);
  t = fminf(fmaxf(floorf(t), 0.0f), (float)(nb - 1));
  return buckets[(int)t];
}

__device__ __forceinline__ unsigned char bk_out(float v, float q, int n,
                                                const float* __restrict__ tab,
                                                const unsigned char* cv,
                                                const BkFeature& m) {
  if (m.is_cat)
    return (n < m.count && tab[n] == q) ? cv[n] : (unsigned char)m.miss_bin;
  if (v != v) return (unsigned char)m.nan_bin;
  return (unsigned char)fminf((float)n, m.clamp);
}

// Bin four values of one feature, rows lane + 32 i of the value tile row
// x, into the bin tile row o: each key's bucket, then D probes among the
// bucket's bounds (a probe past the bucket's end reads the lane at p,
// taken or not without effect), four keys interleaved.
template <int D>
__device__ __forceinline__ void bk_bin4(const BkFeature& m,
                                        const float* __restrict__ x,
                                        int nb,
                                        const int* __restrict__ buckets,
                                        const float* __restrict__ tab,
                                        const unsigned char* cv,
                                        unsigned char* o, int lane) {
  float v[4], q[4];
  int p[4], e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = x[lane + 32 * i];
    q[i] = bk_query(v[i], m);
    const int g = bk_bucket(q[i], m, nb, buckets);
    p[i] = g & 0xFFFF;
    e[i] = g >> 16;
  }
#pragma unroll
  for (int step = D > 0 ? 1 << (D - 1) : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = min(p[i] + step, e[i]);
      if (tab[max(c - 1, p[i])] < q[i]) p[i] = c;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[lane + 32 * i] = bk_out(v[i], q[i], p[i], tab, cv, m);
}

// bk_bin4 at the row's depth
__device__ __forceinline__ void bk_bin(const BkFeature& m,
                                       const float* __restrict__ x, int nb,
                                       const int* __restrict__ buckets,
                                       const float* __restrict__ tab,
                                       const unsigned char* cv,
                                       unsigned char* o, int lane) {
  switch (m.depth) {
#define BK_DEPTH(d)                                    \
  case d:                                              \
    bk_bin4<d>(m, x, nb, buckets, tab, cv, o, lane);   \
    break;
    BK_DEPTH(0) BK_DEPTH(1) BK_DEPTH(2) BK_DEPTH(3) BK_DEPTH(4)
    BK_DEPTH(5) BK_DEPTH(6) BK_DEPTH(7) BK_DEPTH(8)
#undef BK_DEPTH
    default:
      bk_bin4<9>(m, x, nb, buckets, tab, cv, o, lane);
  }
}

// Shared-memory bytes of a block over Fg features of a B-lane table with
// grids of NB buckets (ops/bucketize.py _smem_bytes plans with the same
// sum).
__host__ __device__ __forceinline__ long long bk_smem(int Fg, int B,
                                                      int NB) {
  return (long long)Fg * (4LL * B + 4LL * (LGBT_BK_GRID_HEAD + NB) +
                          4LL * LGBT_BK_XP + 4LL * LGBT_META + B +
                          LGBT_BK_OP);
}

// tile t's values of this lane's feature: rows warp + 8 i, i < 16
__device__ __forceinline__ void bk_load(float (&v)[LGBT_BK_RPW],
                                        const float* __restrict__ X,
                                        long long n, long long ldx,
                                        long long col, bool mine,
                                        long long t, int warp) {
  const long long r0 = t * LGBT_BK_ROWS + warp;
  const float* p = X + r0 * ldx + col;
  const long long step = LGBT_BK_WARPS * ldx;
  const int left = (int)min(n - r0, (long long)LGBT_BK_ROWS);
#pragma unroll
  for (int i = 0; i < LGBT_BK_RPW; ++i) {
    v[i] = (mine && i * LGBT_BK_WARPS < left) ? *p : 0.0f;
    p += step;
  }
}

__global__ void __launch_bounds__(LGBT_THREADS)
bucketize_kernel(const float* __restrict__ X, long long n, long long ldx,
                 const int* __restrict__ cols, int F, int Fg, int G,
                 const float* __restrict__ table,
                 const int* __restrict__ grids, int NB,
                 const float* __restrict__ cat_val,
                 const float* __restrict__ meta, int B,
                 unsigned char* __restrict__ out, long long s_row,
                 long long s_feat, int vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int GP = LGBT_BK_GRID_HEAD + NB;                 // grid row pitch
  float* s_tab = reinterpret_cast<float*>(smem_raw);     // [Fg, B]
  int* s_grid = reinterpret_cast<int*>(s_tab + Fg * B);  // [Fg, GP]
  float* s_x = reinterpret_cast<float*>(s_grid + Fg * GP);  // [Fg, XP]
  float* s_meta = s_x + Fg * LGBT_BK_XP;                 // [Fg, 8]
  unsigned char* s_cv =
      reinterpret_cast<unsigned char*>(s_meta + Fg * LGBT_META);  // [Fg, B]
  unsigned char* s_out = s_cv + Fg * B;                  // [Fg, OP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x % G;
  const int f0 = g * Fg;
  const int fn = min(Fg, F - f0);
  const long long n_tiles = (n + LGBT_BK_ROWS - 1) / LGBT_BK_ROWS;
  const long long step = gridDim.x / G;
  long long t = blockIdx.x / G;
  const bool mine = lane < fn;
  const long long col = mine ? (cols ? cols[f0 + lane] : f0 + lane) : 0;

  // this block's first tile goes out before the tables are staged
  float v[LGBT_BK_RPW];
  if (t < n_tiles) bk_load(v, X, n, ldx, col, mine, t, warp);

  // stage the group's rows, grids and cat_val bytes (16-byte loads), meta
  const int b4 = B >> 2, lb = __ffs(b4) - 1;
  for (int i = threadIdx.x; i < fn * b4; i += blockDim.x) {
    const int fl = i >> lb, j = (i & (b4 - 1)) << 2;
    const long long src = (long long)(f0 + fl) * B + j;
    *reinterpret_cast<float4*>(s_tab + fl * B + j) =
        *reinterpret_cast<const float4*>(table + src);
    const float4 c = *reinterpret_cast<const float4*>(cat_val + src);
    *reinterpret_cast<uchar4*>(s_cv + fl * B + j) =
        make_uchar4((unsigned char)c.x, (unsigned char)c.y,
                    (unsigned char)c.z, (unsigned char)c.w);
  }
  for (int i = threadIdx.x; i < fn * GP; i += blockDim.x)
    s_grid[i] = grids[(long long)f0 * GP + i];
  for (int i = threadIdx.x; i < fn * LGBT_META; i += blockDim.x)
    s_meta[i] = meta[(long long)f0 * LGBT_META + i];

  const bool feat_major = s_row == 1;
  for (; t < n_tiles; t += step) {
    __syncthreads();  // staging done; the last tile's search and stores too
    if (mine) {
#pragma unroll
      for (int i = 0; i < LGBT_BK_RPW; ++i)
        s_x[lane * LGBT_BK_XP + warp + i * LGBT_BK_WARPS] = v[i];
    }
    __syncthreads();
    const long long r0 = t * LGBT_BK_ROWS;
    const int rows = (int)min((long long)LGBT_BK_ROWS, n - r0);
    if (t + step < n_tiles)
      bk_load(v, X, n, ldx, col, mine, t + step, warp);

    // a warp per feature: a lane bins four rows 32 apart (rows past the
    // tile's end bin stale values that are never stored)
    for (int fl = warp; fl < fn; fl += LGBT_BK_WARPS) {
      const int* grid = s_grid + fl * GP;
      const BkFeature m = bk_feature(s_meta + fl * LGBT_META, grid);
      bk_bin(m, s_x + fl * LGBT_BK_XP, NB, grid + LGBT_BK_GRID_HEAD,
             s_tab + fl * B, s_cv + fl * B, s_out + fl * LGBT_BK_OP, lane);
    }
    __syncthreads();

    if (feat_major) {
      // a warp per feature, 4 rows per lane
      const int r = lane * 4;
      for (int fl = warp; fl < fn; fl += LGBT_BK_WARPS) {
        unsigned char* o = out + (long long)(f0 + fl) * s_feat + r0 + r;
        const unsigned char* s = s_out + fl * LGBT_BK_OP + r;
        if (vec4 && r + 4 <= rows) {
          *reinterpret_cast<uint32_t*>(o) =
              *reinterpret_cast<const uint32_t*>(s);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (r + k < rows) o[k] = s[k];
        }
      }
    } else if (mine) {
      // a warp per row, a lane per feature
      for (int r = warp; r < rows; r += LGBT_BK_WARPS)
        out[(r0 + r) * s_row + (long long)(f0 + lane) * s_feat] =
            s_out[lane * LGBT_BK_OP + r];
    }
  }
}

// One launch over F features in G groups of Fg (the last may be short):
// table and cat_val [F, B] (B a multiple of 4), grids [F, 2 + NB] int32
// (lo and scale as f32 bits, then first | end << 16 per bucket), meta
// [F, 8], on `grid` blocks, a multiple of G (ops/bucketize.py
// plan_bucketize), cut to the blocks that fit on the card at once; vec4:
// the output is feature-major (s_row == 1) with a 4-byte-aligned base and
// s_feat a multiple of 4.
// One launch over F features in G groups of Fg (the last may be short):
// table and cat_val [F, B] (B a multiple of 4), grids [F, 2 + NB] int32
// (lo and scale as f32 bits, then first | end << 16 per bucket), meta
// [F, 8], on `grid` blocks, a multiple of G (ops/bucketize.py
// plan_bucketize), cut to the blocks that fit on the card at once; vec4:
// the output is feature-major (s_row == 1) with a 4-byte-aligned base and
// s_feat a multiple of 4.
extern "C" int lgbt_bucketize(const void* X, long long n, long long ldx,
                              const void* cols, int F, int Fg, int G,
                              int grid, const void* table, const void* grids,
                              int NB, const void* cat_val, const void* meta,
                              int B, void* out, long long s_row,
                              long long s_feat, int vec4, void* stream) {
  const long long smem = bk_smem(Fg, B, NB);
  if (smem > 48 * 1024) {
    cudaError_t a = cudaFuncSetAttribute(
        bucketize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (a != cudaSuccess) return (int)a;
  }
  cudaError_t c = cudaFuncSetAttribute(
      bucketize_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (c != cudaSuccess) return (int)c;
  // the planner counts the blocks that fit by shared memory; registers
  // may fit fewer, and a block past them would run as a second wave
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bucketize_kernel, LGBT_THREADS, (size_t)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int fit = per_sm * sms / G;
  if (fit >= 1 && grid / G > fit) grid = G * fit;
  bucketize_kernel<<<grid, LGBT_THREADS, (size_t)smem,
                     (cudaStream_t)stream>>>(
      (const float*)X, n, ldx, (const int*)cols, F, Fg, G,
      (const float*)table, (const int*)grids, NB, (const float*)cat_val,
      (const float*)meta, B, (unsigned char*)out, s_row, s_feat, vec4);
  return (int)cudaGetLastError();
}
