// The tiled accumulation engine of the port's slot histograms: what
// hist_slots.cu (kernel #1), hist_rowwise.cu (#7, #8) and the three wave
// kernels wave_pass.cu (#3), wave_pass_fused.cu (#9) and
// wave_pass_fused_tiled.cu (#10) sweep their rows with.
//
//   out[k, c, col] = sum_r vals[c, r] * [slot[r] == k] * [col(r) hit]
//
// over the columns of one (slot, channel) row of the output, `row_len`
// wide: the uniform [F, B] grid of #1 and #10 (row_len = F * B), or the
// flat per-column-offset buffer of the row-wise layouts (row_len = total).
// Rows whose slot is outside [0, K) add nothing; so does a bin at or past
// its column's width.
//
// Templated on
//   (a) the bin reader: where row r's bin of storage column f comes from,
//       how wide the column is and where its cells start in the tile:
//       UniformBinsOf ([F, N] uint8 storage, B bins a column, or past 256
//       bins uint16, whose tile may hold a range of one column's bins) or
//       FlatBins
//       (per-column descriptors: the byte row, the nibble of the column's
//       bits in it, its width and flat offset; FlatBins<false> the plain
//       row-wise storage, FlatBins<true> the nibble-packed one plus its
//       remainder);
//   (b) the slot source: an [N] int32 slot array, the caller's (#1, #7,
//       #8) or the one written by a wave's membership pass (#3, #9, #10);
//       null puts every row in slot 0.
//
// A caller may hand the sweep its rows instead of a slot array: the row ids
// at positions [offsets[0], offsets[1]) of an id list, the bounds in device
// memory (#1's window, the compact grower's leaf of one split). The blocks
// are planned for N rows, and those past the window's pieces exit at once.
//
// Bound: bytes (each row's bins, values and slot read once, the output
// written once). What limits the sweep on the card is its f64 adds in
// shared memory: sm_90a has no shared f64 atomic add, so atomicAdd(double*)
// compiles to a compare-and-swap loop (SASS ATOMS.CAST.SPIN.64; the int32
// add is ATOMS.ADD). The design (the planners in ops/histogram_cuda.py size
// every launch; times in PERF.md, from scripts/hist_slots_bench.py on an
// H100 80GB HBM3 at 700 W):
//
//   tiles     the (slot, column) cells are cut into tiles whose
//             accumulators fit HIST_SMEM_BUDGET (48 KB), so 4-5 blocks of
//             8 warps fit per SM at every K, and no atomic of the sweep
//             leaves shared memory; a block reads its tile's columns only.
//             A tile is a range of slots times a range of columns; with
//             unequal widths (FlatBins) a column range of the flat buffer,
//             the ranges of all tiles together covering [0, row_len). Each
//             tile's rows are cut into pieces of at least MIN_SEGMENT_ROWS
//             (128) rows, one block each, one wave of the card.
//   grouping  when K > 1, three small kernels sort the row ids by slot (a
//             stable counting sort: per-warp counts, a per-slot scan, a
//             scatter; a warp per 256 rows or more), so a block sweeps only
//             the rows of its slot tile.
//   balance   a wave's smaller children differ in size by orders of
//             magnitude, so with grouped rows each slot tile takes pieces
//             in proportion to its rows. A block finds its slot tile with a
//             warp scan over the tiles' piece counts, 32 tiles a step.
//   merge     lanes of a warp that hit the same cell are merged before the
//             atomic (__match_any_sync, then a tree of f64 shuffles), one
//             atomic per distinct cell: Zipf-popular categorical bins
//             otherwise serialise a warp's compare-and-swaps on one
//             address. It costs at 63 uniform bins, so the planners turn
//             it on, for every column of a tile, where some column is
//             wider than 64 (on the Criteo storage merging only those
//             columns left the narrow Zipf categorical ones serialised).
//   pairing   at K = 1 without the merge (C = 2, f32) the two channels of a
//             cell sit side by side and one 128-bit compare-and-swap adds
//             both (ATOMS.CAS.128): half the atomics at the root.
//   direct    little work on the uniform grid (the planner's rule for the
//             uniform kernels): the first version's sweep, a row per thread
//             into global accumulators, or at K = 1 a private copy per
//             block (wave_pass.cu rounds its sums in the same,
//             cooperative, launch).
//
// The flush: a tile of one piece writes its cells straight to the output;
// otherwise each block adds its nonzero cells into the f64 accumulators in
// global memory (one atomic per nonzero cell per block, the sweep's only
// global atomics), and the last block of the tile (a completion counter)
// rounds the tile to f32, so no separate rounding launch runs. Float
// channels accumulate in f64 and int8 channels in int32, so a bin's sum
// does not depend on the order of the adds (common.cuh).
#pragma once

#include "common.cuh"

#define LGBT_GROUP_ROWS 1024   // rows a grouping warp prefetches at once
// resident sweep blocks per SM that the registers allow (<= 51 a thread);
// MAX_BLOCKS_PER_SM in ops/histogram_cuda.py
#define LGBT_TILE_BLOCKS_PER_SM 5

// the output of a value type: f32 sums rounded from the f64 accumulators,
// or the int32 accumulators themselves
template <typename V> struct OutOf;
template <> struct OutOf<float> {
  typedef float T;
  static const bool kRound = true;
};
template <> struct OutOf<int8_t> {
  typedef int T;
  static const bool kRound = false;
};

// ---------------------------------------------------------------------------
// Row grouping (K > 1): rows[offsets[k] .. offsets[k+1]) are the ids of the
// rows of slot k, ascending. Warp w of the W warps owns rows [w*chunk,
// (w+1)*chunk). wcnt is [K, W] (slot-major), totals [K], offsets [K + 1].
// ---------------------------------------------------------------------------
__device__ __forceinline__ void group_chunk(long long N, int W, int w,
                                           long long* lo, long long* hi) {
  long long chunk = (N + W - 1) / W;
  chunk = (chunk + 31) / 32 * 32;
  *lo = (long long)w * chunk;
  *hi = *lo + chunk < N ? *lo + chunk : N;
}

// Per-warp counts of the rows in each slot; or, with rows != null, the
// scatter of the row ids to their grouped positions (my[k] holds the next
// free position of slot k for this warp).
template <bool SCATTER>
__global__ void __launch_bounds__(LGBT_THREADS)
group_pass_kernel(const int* __restrict__ slot, long long N, int K, int W,
                  int* __restrict__ wcnt, const int* __restrict__ totals,
                  int* __restrict__ offsets, int* __restrict__ rows) {
  extern __shared__ int cnt[];                       // [warps per block][K]
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int w = blockIdx.x * (LGBT_THREADS / 32) + wl;
  if (w >= W) return;                                // warp-uniform
  int* my = cnt + wl * K;
  if (SCATTER) {
    // this warp's start in slot k: offsets[k] + the counts of the warps
    // before it (wcnt, scanned in place by group_scan_kernel)
    int carry = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int t = k < K ? totals[k] : 0;
      int inc = t;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += u;
      }
      if (k < K) {
        my[k] = carry + inc - t + wcnt[(long long)k * W + w];
        if (w == 0) offsets[k] = carry + inc - t;
      }
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (w == 0 && lane == 0) offsets[K] = carry;
  } else {
    for (int k = lane; k < K; k += 32) my[k] = 0;
  }
  __syncwarp();
  long long lo, hi;
  group_chunk(N, W, w, &lo, &hi);
  for (long long r0 = lo; r0 < hi; r0 += LGBT_GROUP_ROWS) {
    int s[LGBT_GROUP_ROWS / 32];
#pragma unroll
    for (int j = 0; j < LGBT_GROUP_ROWS / 32; ++j) {
      const long long r = r0 + j * 32 + lane;
      s[j] = r < hi ? slot[r] : -1;
    }
#pragma unroll
    for (int j = 0; j < LGBT_GROUP_ROWS / 32; ++j) {
      const bool ok = (unsigned)s[j] < (unsigned)K;
      const unsigned act = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const unsigned peers = __match_any_sync(act, s[j]);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) {
          base = my[s[j]];
          my[s[j]] = base + __popc(peers);
        }
        if (SCATTER) {
          base = __shfl_sync(act, base, leader);
          rows[base + __popc(peers & ((1u << lane) - 1u))] =
              (int)(r0 + j * 32 + lane);
        }
      }
      __syncwarp();
    }
  }
  if (!SCATTER)
    for (int k = lane; k < K; k += 32) wcnt[(long long)k * W + w] = my[k];
}

// One block per slot: exclusive scan of the slot's W warp counts in place
// (W <= 1024), the slot's total into totals[k].
__global__ void __launch_bounds__(1024)
group_scan_kernel(int* __restrict__ wcnt, int W, int* __restrict__ totals) {
  __shared__ int wsum[32];
  int* a = wcnt + (long long)blockIdx.x * W;
  const int t = threadIdx.x, lane = t & 31, wl = t >> 5;
  const int v = t < W ? a[t] : 0;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += u;
  }
  if (lane == 31) wsum[wl] = inc;
  __syncthreads();
  if (wl == 0) {
    const int x = wsum[lane];
    int y = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += u;
    }
    wsum[lane] = y - x;                              // exclusive
  }
  __syncthreads();
  const int excl = wsum[wl] + inc - v;
  if (t < W) a[t] = excl;
  if (t == 1023) totals[blockIdx.x] = excl + v;
}

// The three grouping launches; scratch is [K*W wcnt | K totals | K+1
// offsets | N row ids] int32. Returns the row ids and offsets.
static inline void lgbt_group_rows(const int* slot, long long N, int K,
                                   int W, int* scratch, const int** rows,
                                   const int** offsets, cudaStream_t st) {
  int* wcnt = scratch;
  int* totals = wcnt + (long long)K * W;
  int* offs = totals + K;
  int* ids = offs + K + 1;
  const int blocks = (W + LGBT_THREADS / 32 - 1) / (LGBT_THREADS / 32);
  const size_t smem = (size_t)(LGBT_THREADS / 32) * K * sizeof(int);
  group_pass_kernel<false><<<blocks, LGBT_THREADS, smem, st>>>(
      slot, N, K, W, wcnt, totals, offs, ids);
  group_scan_kernel<<<K, 1024, 0, st>>>(wcnt, W, totals);
  group_pass_kernel<true><<<blocks, LGBT_THREADS, smem, st>>>(
      slot, N, K, W, wcnt, totals, offs, ids);
  *rows = ids;
  *offsets = offs;
}

// ---------------------------------------------------------------------------
// Little work on the uniform grid: the direct sweep
// ---------------------------------------------------------------------------
// A row per thread, grid-stride, add_row into the [K, C, F, B]
// accumulators: in global memory (K > 1), where the adds go to L2 without
// the warp waiting for them; or, with SMEM (K = 1, the histogram within
// one tile's budget), into a private copy in shared memory that each block
// adds into the global ones at its end. Where the rows are few, the tiled
// sweep's row grouping, per-tile zeroing and flush and its pieces' edges
// cost more than the rows' adds (the planner's rule, PERF.md).
template <typename V, bool SMEM, typename T>
__device__ __forceinline__ void direct_sweep(
    const T* __restrict__ X, const V* __restrict__ vals,
    const int* __restrict__ slot, typename AccOf<V>::T* __restrict__ acc,
    long long N, int F, int C, int K, int B) {
  typedef typename AccOf<V>::T A;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int hsize = K * C * F * B;
  if (SMEM) {
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = (A)0;
    __syncthreads();
  }
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    const int k = slot ? slot[r] : 0;
    if ((unsigned)k < (unsigned)K)
      add_row<V, A>(SMEM ? sh : acc, X, vals, N, F, C, B, r, k);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < hsize; i += blockDim.x)
      if (sh[i] != (A)0) atomicAdd(acc + i, sh[i]);
  }
}

template <typename V, bool SMEM, typename T>
__global__ void __launch_bounds__(LGBT_THREADS)
hist_direct_kernel(const T* __restrict__ X, const V* __restrict__ vals,
                   const int* __restrict__ slot,
                   typename AccOf<V>::T* __restrict__ acc, long long N,
                   int F, int C, int K, int B) {
  direct_sweep<V, SMEM>(X, vals, slot, acc, N, F, C, K, B);
}

// Zero the accumulators (acc: f64 for f32 values, the int32 output for
// int8 values; not when `zeroed`, the caller having zeroed them) and
// launch the direct sweep on the first version's grids for num_sms SMs.
// The f64 sums are left for the caller to round.
template <typename V, typename T>
static void lgbt_direct_run(const T* X, const V* vals, const int* slot,
                            typename AccOf<V>::T* acc, long long N, int F,
                            int C, int K, int B, int num_sms,
                            cudaStream_t st, bool zeroed = false) {
  typedef typename AccOf<V>::T A;
  const long long n = (long long)K * C * F * B;
  if (!zeroed) cudaMemsetAsync(acc, 0, n * sizeof(A), st);
  if (K == 1) {
    const int blocks = lgbt_grid(N, num_sms,
                                 lgbt_smem_blocks_per_sm(n * sizeof(A)));
    hist_direct_kernel<V, true, T><<<blocks, LGBT_THREADS, n * sizeof(A),
                                     st>>>(
        X, vals, slot, acc, N, F, C, K, B);
  } else {
    hist_direct_kernel<V, false, T><<<lgbt_grid(N, num_sms, 8),
                                      LGBT_THREADS, 0, st>>>(
        X, vals, slot, acc, N, F, C, K, B);
  }
}

// ---------------------------------------------------------------------------
// The tiled sweep
// ---------------------------------------------------------------------------
// {p[0], p[1]} += {a, b} in shared memory, one 128-bit compare-and-swap
// for the pair (sm_90): the two channels of a paired cell are adjacent.
__device__ __forceinline__ void atomic_add_pair(double* p, double a,
                                                double b) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(p);
  unsigned long long o0 = __double_as_longlong(p[0]);
  unsigned long long o1 = __double_as_longlong(p[1]);
  while (true) {
    const unsigned long long n0 =
        __double_as_longlong(__longlong_as_double(o0) + a);
    const unsigned long long n1 =
        __double_as_longlong(__longlong_as_double(o1) + b);
    unsigned long long r0, r1;
    asm volatile(
        "{\n\t.reg .b128 cmp, swp, old;\n\t"
        "mov.b128 cmp, {%2, %3};\n\t"
        "mov.b128 swp, {%4, %5};\n\t"
        "atom.shared.cas.b128 old, [%6], cmp, swp;\n\t"
        "mov.b128 {%0, %1}, old;\n\t}"
        : "=l"(r0), "=l"(r1)
        : "l"(o0), "l"(o1), "l"(n0), "l"(n1), "r"(sa)
        : "memory");
    if (r0 == o0 && r1 == o1) return;
    o0 = r0;
    o1 = r1;
  }
}

// hist[idx + c * cstride] += x[c] for c < C, skipping zeros; PAIR: C == 2,
// cstride == 1, one 128-bit CAS for both channels
template <typename A, bool PAIR>
__device__ __forceinline__ void cell_add(A* hist, int idx, const A* x, int C,
                                         int cstride) {
  if (PAIR) {
    if (x[0] != (A)0 || x[1] != (A)0)
      atomic_add_pair((double*)(hist + idx), (double)x[0], (double)x[1]);
    return;
  }
#pragma unroll
  for (int c = 0; c < LGBT_MAX_C; ++c)
    if (c < C && x[c] != (A)0) atomicAdd(hist + idx + c * cstride, x[c]);
}

// cell_add for every lane with ok, one per distinct idx in the warp: each
// group of lanes with equal idx sums its values in a tree of shuffles into
// its lowest lane. Every lane of the warp calls it.
template <typename A, bool PAIR>
__device__ __forceinline__ void merged_add(A* hist, int idx, const A* v,
                                           int C, int cstride, bool ok,
                                           int lane) {
  const unsigned act = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  const unsigned peers = __match_any_sync(act, idx);
  const unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & ~((2u << lane) - 1u);      // higher peers
  unsigned rel = rank;
  A x[LGBT_MAX_C];
#pragma unroll
  for (int c = 0; c < LGBT_MAX_C; ++c) x[c] = v[c];
  while (__any_sync(act, rest != 0)) {
    const int next = __ffs(rest);                    // 1 + peer lane, or 0
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < LGBT_MAX_C; ++c) {
      if (c < C) {
        const A t = __shfl_sync(act, x[c], src);
        if (next) x[c] += t;
      }
    }
    rest &= ~__ballot_sync(act, rel & 1u);           // odd ranks are done
    rel >>= 1;
  }
  if (rank == 0) cell_add<A, PAIR>(hist, idx, x, C, cstride);
}

// One tile: slots [k0, k0 + nk) x storage columns [f0, f0 + nf), whose
// cells are the `span` output columns from `lo` of each (slot, channel)
// row. Its accumulators in shared memory are [nk][C][span], or
// [nk][span][2] with PAIR.
struct Tile {
  int k0, nk, f0, nf, lo, span;
};

// Uniform [F, N] storage of B bins a column, of bin type T (uint8, or
// uint16 past 256 bins), tiles of `fpt` columns. CUT: where one column's B
// cells do not fit a tile (past 3072 bins at C = 2 in f64), a tile holds the
// bins [b0, b0 + bw) of one column, `nbt` tiles of `bpt` bins a column; a
// bin outside them reads as `bw`, past the tile.
template <typename T, bool CUT>
struct UniformBinsOf {
  static const int kPrefetch = 1;
  const T* __restrict__ X;
  int F, B, fpt;
  int nbt, bpt;                          // CUT: bin tiles a column, their bins
  int b0, bw;                            // CUT: this tile's bins (setup)
  __device__ __forceinline__ void cols(int ft, Tile* t) const {
    if (CUT) {
      const int bt = ft % nbt;
      t->f0 = ft / nbt;
      t->nf = 1;
      t->lo = t->f0 * B + bt * bpt;
      t->span = min(bpt, B - bt * bpt);
      return;
    }
    t->f0 = ft * fpt;
    t->nf = min(F - t->f0, fpt);
    t->lo = t->f0 * B;
    t->span = t->nf * B;
  }
  __device__ __forceinline__ long long row_len() const {
    return (long long)F * B;
  }
  static __device__ __forceinline__ int desc_bytes() { return 0; }
  __device__ __forceinline__ void setup(const Tile& t, unsigned char*) {
    if (CUT) {
      b0 = t.lo - t.f0 * B;
      bw = t.span;
    }
  }
  __device__ __forceinline__ int width(int) const { return CUT ? bw : B; }
  __device__ __forceinline__ int loc(int fl) const { return CUT ? 0 : fl * B; }
  __device__ __forceinline__ int bin(const Tile& t, int fl, long long N,
                                     long long r) const {
    const int b = X[(long long)(t.f0 + fl) * N + r];
    if (!CUT) return b;
    return (unsigned)(b - b0) < (unsigned)bw ? b - b0 : bw;
  }
};
typedef UniformBinsOf<uint8_t, false> UniformBins;

// The uniform storage read P columns ahead: a row's bins of P columns are
// loaded before any of their adds, so their loads are in flight together
// (the shared-memory compare-and-swap of an add orders the next load
// after it). The waves of kernels #3 and #9, whose smaller children put
// few rows in a block, wait on that chain of loads and adds.
template <int P>
struct UniformBinsAhead : UniformBins {
  static const int kPrefetch = P;
};

// One storage column of the flat layout as the sweep reads it: the byte
// row holding its bins, its first cell in the tile, its width and, in the
// packed layout, where its bits sit in the byte.
struct __align__(16) FlatCol {
  const uint8_t* row;
  int loc;
  int width_bits;                        // width | shift << 16 | nibble << 24
};

// The flat per-column-offset layout (kernels #7 and #8): desc is [4, F]
// int32 rows offset, width, nibble index (-1: a whole byte) and byte row
// (of X for a nibble, or for a whole byte when Xu is null; else of Xu),
// then cuts [nft + 1], the first column of each tile. A tile's span runs
// from its first column's offset to the next tile's (the last tile's to
// `total`), so the tiles cover the flat buffer, the padding between
// column chunks included. Each block stages its tile's columns in shared
// memory (desc_bytes, before the accumulators). PACKED: some columns are
// nibbles (kernel #8); else every column is a whole byte of X (#7). A
// thread reads the bins of kPrefetch columns of its row before it adds
// any of them, so their loads are in flight together.
template <bool PACKED>
struct FlatBins {
  static const int kPrefetch = 4;
  const uint8_t* __restrict__ X;
  const uint8_t* __restrict__ Xu;        // null: every byte row in X
  const int* __restrict__ desc;
  long long N;
  int F, total, max_cols;
  const FlatCol* sc;
  __device__ __forceinline__ void cols(int ft, Tile* t) const {
    const int* cuts = desc + 4 * F;
    t->f0 = cuts[ft];
    t->nf = cuts[ft + 1] - t->f0;
    t->lo = desc[t->f0];
    t->span = (t->f0 + t->nf < F ? desc[t->f0 + t->nf] : total) - t->lo;
  }
  __device__ __forceinline__ long long row_len() const { return total; }
  __device__ __forceinline__ int desc_bytes() const {
    return max_cols * (int)sizeof(FlatCol);
  }
  // fill the tile's column records; the caller synchronises
  __device__ __forceinline__ void setup(const Tile& t, unsigned char* raw) {
    FlatCol* c = reinterpret_cast<FlatCol*>(raw);
    for (int fl = threadIdx.x; fl < t.nf; fl += blockDim.x) {
      const int f = t.f0 + fl;
      const int p = desc[2 * F + f];
      const uint8_t* base = p >= 0 || !Xu ? X : Xu;
      FlatCol d;
      d.row = base + (long long)(p >= 0 ? p >> 1 : desc[3 * F + f]) * N;
      d.loc = desc[f] - t.lo;
      d.width_bits = desc[F + f];
      if (p >= 0) d.width_bits |= (4 * (p & 1)) << 16 | 1 << 24;
      c[fl] = d;
    }
    sc = c;
  }
  __device__ __forceinline__ int width(int fl) const {
    return PACKED ? sc[fl].width_bits & 0xFFFF : sc[fl].width_bits;
  }
  __device__ __forceinline__ int loc(int fl) const { return sc[fl].loc; }
  __device__ __forceinline__ int bin(const Tile&, int fl, long long,
                                     long long r) const {
    const FlatCol& c = sc[fl];
    const int b = __ldg(c.row + r);
    if (!PACKED) return b;
    const int wb = c.width_bits;
    return wb >> 24 ? (b >> ((wb >> 16) & 7)) & 15 : b;
  }
};

// the output index of cell i of tile t: [nk][C][span] cells, or
// [nk][span][2] with PAIR, into rows of row_len columns
template <bool PAIR>
__device__ __forceinline__ long long tile_global(const Tile& t, int i, int C,
                                                 long long row_len) {
  if (PAIR) {
    const int c = i & 1, q = i >> 1;
    const int lc = q % t.span, kl = q / t.span;
    return (long long)((t.k0 + kl) * C + c) * row_len + t.lo + lc;
  }
  const int lc = i % t.span, kc = i / t.span;
  return (long long)(t.k0 * C + kc) * row_len + t.lo + lc;
}

// Zero tile t's accumulators and add rows [lo, hi) into them: positions of
// `rows` (grouped ids) or rows themselves; with read_slot a row's slot is
// read and rows outside the tile's slots skipped. Ends synchronised.
template <typename V, bool MERGE, bool PAIR, typename R>
__device__ __forceinline__ void sweep_tile(
    typename AccOf<V>::T* sh, const Tile& t, const R& rd,
    const V* __restrict__ vals, const int* __restrict__ slot,
    const int* __restrict__ rows, bool read_slot, long long lo, long long hi,
    long long N, int C) {
  typedef typename AccOf<V>::T A;
  const int fb = t.span;                 // cells of one (slot, channel)
  const int cells = t.nk * C * fb;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = (A)0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long i0 = lo; i0 < hi; i0 += blockDim.x) {
    const long long i = i0 + threadIdx.x;
    bool ok = i < hi;
    long long r = 0;
    int kl = 0;
    if (ok) {
      r = rows ? rows[i] : i;
      if (read_slot) {
        kl = slot[r] - t.k0;
        ok = (unsigned)kl < (unsigned)t.nk;
      }
    }
    A v[LGBT_MAX_C];
    bool any = false;
#pragma unroll
    for (int c = 0; c < LGBT_MAX_C; ++c) {
      v[c] = ok && c < C ? (A)vals[(long long)c * N + r] : (A)0;
      any |= v[c] != (A)0;
    }
    ok = ok && any;
    if (MERGE) {
      if (__ballot_sync(0xffffffffu, ok) == 0u) continue;   // warp-uniform
    } else if (!ok) {
      continue;
    }
    // cell (kl, local column) of [nk][C][span], or pair (kl, local
    // column) of [nk][span][2] with PAIR
    const int base = PAIR ? kl * fb : kl * C * fb;
    constexpr int P = R::kPrefetch;
    for (int f0 = 0; f0 < t.nf; f0 += P) {
      int bq[P];
#pragma unroll
      for (int q = 0; q < P; ++q)
        bq[q] = ok && f0 + q < t.nf ? rd.bin(t, f0 + q, N, r) : 0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int fl = f0 + q;
        if (P > 1 && fl >= t.nf) break;  // warp-uniform
        const int w = rd.width(fl);
        const int b = ok ? bq[q] : w;
        const int cell = base + rd.loc(fl) + b;
        const int idx = PAIR ? cell * 2 : cell;
        if (MERGE)
          merged_add<A, PAIR>(sh, idx, v, C, fb, b < w, lane);
        else if (b < w)
          cell_add<A, PAIR>(sh, idx, v, C, fb);
      }
    }
  }
  __syncthreads();
}

// Block (tile, piece): each tile's rows are cut into `pieces` even pieces
// and its block of piece j sweeps piece j. Grouped rows (rows != null): per
// column tile, the R = offsets[K] - offsets[0] grouped rows (offsets[0] is
// 0 but for a caller's window) make at most `segs` pieces
// of at least min_rows rows, and each slot tile takes pieces in proportion
// to its rows, so a wave's large and small children cost alike and no
// block crosses a tile's edge; block p of column tile ft finds its (slot
// tile, piece) by walking the tiles' piece counts. Otherwise each
// tile sweeps [0, N) in `segs` pieces. A tile of one piece writes its
// cells to the output; else each block adds its nonzero cells into the f64
// accumulators in global memory and the last block of the tile (a
// completion counter) rounds the tile to f32.
template <typename R, typename V, bool MERGE, bool PAIR>
__global__ void __launch_bounds__(LGBT_THREADS, LGBT_TILE_BLOCKS_PER_SM)
hist_tiles_kernel(R rd, const V* __restrict__ vals,
                  const int* __restrict__ slot, const int* __restrict__ rows,
                  const int* __restrict__ offsets,
                  typename AccOf<V>::T* __restrict__ acc,
                  typename OutOf<V>::T* __restrict__ out,
                  unsigned* __restrict__ counters, long long N, int C,
                  int K, int spt, int nft, int segs, int min_rows) {
  typedef typename AccOf<V>::T A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  __shared__ long long walk[4];          // slot tile (-1: none), piece,
                                         // pieces, rows of the slot tile
  A* sh = reinterpret_cast<A*>(smem_raw + rd.desc_bytes());
  int tile;
  long long lo, hi, pieces = 1;
  if (rows) {
    const int ft = blockIdx.x % nft, nst = (K + spt - 1) / spt;
    const long long R_ = offsets[K] - offsets[0];
    // the tiles' rounding up adds at most nst pieces: one wave in all
    const long long P = max(1LL, min((long long)segs - nst, R_ / min_rows));
    const long long target = max(1LL, (R_ + P - 1) / P);
    if (threadIdx.x < 32) {
      // warp 0 finds the slot tile of piece q, 32 slot tiles a step: each
      // lane counts one tile's pieces, a scan across the warp sums them (a
      // walk of one tile a step waited out nst dependent loads)
      const int lane = threadIdx.x;
      long long q = blockIdx.x / nft;
      bool found = false;
      for (int s0 = 0; s0 < nst && !found; s0 += 32) {
        const int st = s0 + lane;
        long long n = 0, pc = 0;
        if (st < nst) {
          n = offsets[min(K, (st + 1) * spt)] - offsets[st * spt];
          pc = (n + target - 1) / target;
        }
        long long inc = pc;
        for (int d = 1; d < 32; d <<= 1) {
          const long long u = __shfl_up_sync(0xffffffffu, inc, d);
          if (lane >= d) inc += u;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, q < inc);
        found = hit != 0u;
        if (found && lane == __ffs(hit) - 1) {
          walk[0] = st;
          walk[1] = q - (inc - pc);
          walk[2] = pc;
          walk[3] = n;
        }
        q -= __shfl_sync(0xffffffffu, inc, 31);
      }
      if (!found && lane == 0) walk[0] = -1;   // past the last piece
    }
    __syncthreads();
    if (walk[0] < 0) return;
    const int st = (int)walk[0];
    const long long q = walk[1], n = walk[3];
    pieces = walk[2];
    tile = st * nft + ft;
    lo = offsets[st * spt] + n * q / pieces;
    hi = offsets[st * spt] + n * (q + 1) / pieces;
  } else {
    tile = blockIdx.x / segs;
    const long long seg = blockIdx.x - (long long)tile * segs;
    pieces = segs;
    lo = N * seg / segs;
    hi = N * (seg + 1) / segs;
  }
  Tile t;
  t.k0 = tile / nft * spt;
  t.nk = min(K - t.k0, spt);
  R bins = rd;
  bins.cols(tile % nft, &t);
  bins.setup(t, smem_raw);
  if (!slot && t.k0 > 0) hi = lo;        // without slots every row is in 0
  sweep_tile<V, MERGE, PAIR>(sh, t, bins, vals, slot, rows,
                             slot && (!rows || t.nk > 1), lo, hi, N, C);
  const int cells = t.nk * C * t.span;
  const long long row_len = bins.row_len();
  if (pieces == 1) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x)
      out[tile_global<PAIR>(t, i, C, row_len)] =
          (typename OutOf<V>::T)sh[i];
    return;
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    if (sh[i] != (A)0)
      atomicAdd(acc + tile_global<PAIR>(t, i, C, row_len), sh[i]);
  if (!OutOf<V>::kRound) return;         // int32: acc is the output
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + tile, 1u) == (unsigned)(pieces - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const long long g = tile_global<PAIR>(t, i, C, row_len);
    out[g] = (typename OutOf<V>::T)__ldcg(acc + g);
  }
}

template <typename R, typename V, bool MERGE, bool PAIR>
static void lgbt_tiles_launch(const R& rd, const V* vals, const int* slot,
                              const int* rows, const int* offsets,
                              typename AccOf<V>::T* acc,
                              typename OutOf<V>::T* out, unsigned* counters,
                              long long N, int C, int K, int spt, int nst,
                              int nft, int segs, int min_rows, size_t smem,
                              cudaStream_t st) {
  if (smem + 1024 > 48 * 1024)          // the static `last` flag rides along
    cudaFuncSetAttribute(hist_tiles_kernel<R, V, MERGE, PAIR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  hist_tiles_kernel<R, V, MERGE, PAIR>
      <<<rows ? nft * (segs + nst) : nst * nft * segs, LGBT_THREADS, smem,
         st>>>(rd, vals, slot, rows, offsets, acc, out, counters, N, C, K,
               spt, nft, segs, min_rows);
}

// The engine's tiled route under a plan (spt, nst, nft, segs, min_rows,
// merge, pair) from ops/histogram_cuda.py, smem the dynamic shared memory
// of a block (the reader's column records, then the accumulators): the
// grouping when group_warps > 0 (slot given; scratch as lgbt_group_rows),
// or the caller's row ids `rows` at positions [offsets[0], offsets[K]) in
// device memory (slot null, K = 1),
// the zeroing of what the blocks add into (not when `zeroed`: the caller's
// membership pass zeroed it, ops/histogram_cuda.py:wave_hist_layout),
// then the sweep. n is the output
// size K * C * row_len. vals f32: out f32, acc [n] f64 followed by nst * nft
// unsigned completion counters when a tile may take several pieces
// (grouped rows, or segs > 1), else unused; vals int8: out int32, the
// accumulators themselves.
template <bool PAIR, typename R, typename V>
static void lgbt_tiles_merge(int merge, const R& rd, const V* vals,
                             const int* slot, const int* rows,
                             const int* offsets, typename AccOf<V>::T* sum,
                             typename OutOf<V>::T* out, unsigned* counters,
                             long long N, int C, int K, int spt, int nst,
                             int nft, int segs, int min_rows, size_t smem,
                             cudaStream_t st) {
  if (merge)
    lgbt_tiles_launch<R, V, true, PAIR>(rd, vals, slot, rows, offsets, sum,
                                        out, counters, N, C, K, spt, nst,
                                        nft, segs, min_rows, smem, st);
  else
    lgbt_tiles_launch<R, V, false, PAIR>(rd, vals, slot, rows, offsets, sum,
                                         out, counters, N, C, K, spt, nst,
                                         nft, segs, min_rows, smem, st);
}

template <typename R, typename V>
static void lgbt_tiles_run(const R& rd, const V* vals, const int* slot,
                           int* scratch, typename OutOf<V>::T* out,
                           typename AccOf<V>::T* acc, long long N, int C,
                           int K, int spt, int nst, int nft, int segs,
                           int min_rows, int merge, int pair,
                           int group_warps, size_t smem, long long n,
                           cudaStream_t st, bool zeroed = false,
                           const int* rows = nullptr,
                           const int* offsets = nullptr) {
  if (group_warps > 0)
    lgbt_group_rows(slot, N, K, group_warps, scratch, &rows, &offsets, st);
  const bool quant = !OutOf<V>::kRound;
  if ((rows || segs > 1) && !zeroed)
    cudaMemsetAsync(quant ? (void*)out : (void*)acc, 0,
                    quant ? n * sizeof(int)
                          : (n + (nst * nft + 1) / 2) * sizeof(double),
                    st);
  if (rows && !quant && !zeroed)
    cudaMemsetAsync(out, 0, n * sizeof(float), st);
  unsigned* counters =
      quant || !acc ? nullptr : (unsigned*)((double*)acc + n);
  typename AccOf<V>::T* sum = quant ? (typename AccOf<V>::T*)out : acc;
  if constexpr (OutOf<V>::kRound) {
    if (pair) {
      lgbt_tiles_merge<true>(merge, rd, vals, slot, rows, offsets, sum, out,
                             counters, N, C, K, spt, nst, nft, segs,
                             min_rows, smem, st);
      return;
    }
  }
  lgbt_tiles_merge<false>(merge, rd, vals, slot, rows, offsets, sum, out,
                          counters, N, C, K, spt, nst, nft, segs, min_rows,
                          smem, st);
}
