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
// once, the output written once). What limits the kernel on the card is its
// f64 adds in shared memory, F*C per row: sm_90a has no shared f64 atomic
// add, so atomicAdd(double*) compiles to a compare-and-swap loop (SASS
// ATOMS.CAST.SPIN.64; the int32 add is ATOMS.ADD). The first version
// reached 1/22 to 1/150 of the byte bound. The design (the planner
// in ops/histogram_cuda.py sizes every launch; times in PERF.md, from
// scripts/hist_slots_bench.py on an H100 80GB HBM3 at 700 W):
//
//   tiles     the first version privatised the whole [K, C, F, B] histogram
//             per block: at the Criteo root (K=1, C=2, F=39, B=256) that is
//             160 KB, one block of 8 warps per SM; from K=16 it spilled to
//             f64 atomics in L2. Here the (slot, feature) cells are cut into
//             tiles whose accumulators fit HIST_SMEM_BUDGET (48 KB), so 4-5
//             blocks of 8 warps fit per SM at every K, and no atomic of the
//             sweep leaves shared memory; a block reads its tile's bins
//             only. Each tile's rows are cut into pieces of at least
//             MIN_SEGMENT_ROWS (128) rows, one block each, one wave of the
//             card (1024 rows cost up to 2.5x at 2^14-2^16 rows and gained
//             nothing at 2^20).
//   grouping  when K > 1, three small kernels below sort the row ids by
//             slot (a stable counting sort: per-warp counts, a per-slot
//             scan, a scatter; a warp per 256 rows or more), so a block
//             sweeps only the rows of its slot tile; re-reading all N slots
//             once per slot tile instead was 4-33x slower at K = 16 and 128.
//   balance   a wave's smaller children differ in size by orders of
//             magnitude, so with grouped rows each slot tile takes pieces
//             in proportion to its rows; a fixed number of pieces per tile
//             left the card waiting on the largest child (Criteo training:
//             6.7 ms of this kernel per round, against 3.0 balanced). A
//             block finds its slot tile with a warp scan over the tiles'
//             piece counts, 32 tiles a step.
//   direct    little work (K > 1 over <= 2^16 rows; K = 1 over <= 2^24
//             (row, feature) pairs when one tile holds the histogram): the
//             first version's sweep, a row per thread into global
//             accumulators, or at K = 1 a private copy per block; there the
//             tiles' fixed costs lost to it by up to 3.4x.
//   merge     lanes of a warp that hit the same cell are merged before the
//             atomic (__match_any_sync, then a tree of f64 shuffles), one
//             atomic per distinct cell: Zipf-popular categorical bins
//             otherwise serialise a warp's compare-and-swaps on one address
//             (1.5-1.6x at the Criteo storage). At 63 uniform bins it costs
//             1.4-2.0x, so the planner turns it on by the bin count (B > 64).
//   pairing   at K = 1 without the merge (B <= 64, C = 2) the two channels
//             of a cell sit side by side and one 128-bit compare-and-swap
//             adds both (ATOMS.CAS.128): half the atomics, 1.16x at the
//             bench root. In the waves (K > 1) it was as often slower as
//             faster, and under the merge it cost 1.1-1.15x, so the planner
//             turns it on for the root histogram only.
//
// The flush: a tile of one piece writes its cells straight to the output;
// otherwise each block adds its nonzero cells into the f64 accumulators in
// global memory, and the last block of the tile (a completion counter)
// rounds the tile to f32, so no separate rounding launch runs. Float
// channels accumulate in f64 and int8 channels in int32, so a bin's sum
// does not depend on the order of the adds (common.cuh).
//
// -Xptxas -v (sm_90a, nvcc 12.8): chip_smoke.py's device line prints the
// registers, spills and static shared memory of every entry function of
// every build; PERF.md keeps this source's.
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

// ---------------------------------------------------------------------------
// Little work: the direct sweep (the first version of this kernel)
// ---------------------------------------------------------------------------
// A row per thread, grid-stride, add_row into the [K, C, F, B]
// accumulators: in global memory (K > 1), where the adds go to L2 without
// the warp waiting for them; or, with SMEM (K = 1, the histogram within
// one tile's budget), into a private copy in shared memory that each block
// adds into the global ones at its end. Where the rows are few, the tiled
// sweep's row grouping, per-tile zeroing and flush and its pieces' edges
// cost more than the rows' adds (the planner's rule, PERF.md).
template <typename V, bool SMEM>
__global__ void __launch_bounds__(LGBT_THREADS)
hist_direct_kernel(const uint8_t* __restrict__ X, const V* __restrict__ vals,
                   const int* __restrict__ slot,
                   typename AccOf<V>::T* __restrict__ acc, long long N,
                   int F, int C, int K, int B) {
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

template <typename V>
static void launch_direct(const uint8_t* X, const V* vals, const int* slot,
                          typename AccOf<V>::T* acc, long long N, int F,
                          int C, int K, int B, int blocks, cudaStream_t st) {
  if (K == 1)
    hist_direct_kernel<V, true>
        <<<blocks, LGBT_THREADS,
           (size_t)C * F * B * sizeof(typename AccOf<V>::T), st>>>(
            X, vals, slot, acc, N, F, C, K, B);
  else
    hist_direct_kernel<V, false><<<blocks, LGBT_THREADS, 0, st>>>(
        X, vals, slot, acc, N, F, C, K, B);
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

// One tile: slots [k0, k0 + nk) x features [f0, f0 + nf). Its accumulators
// in shared memory are cells [nk][C][nf][B], or [nk][nf][B][2] with PAIR.
struct Tile {
  int k0, nk, f0, nf;
};

__device__ __forceinline__ Tile make_tile(int st, int ft, int K, int F,
                                          int spt, int fpt) {
  Tile t;
  t.k0 = st * spt;
  t.nk = min(K - t.k0, spt);
  t.f0 = ft * fpt;
  t.nf = min(F - t.f0, fpt);
  return t;
}

// the output index of cell i of tile t
template <bool PAIR>
__device__ __forceinline__ long long tile_global(const Tile& t, int i, int C,
                                                 int F, int B) {
  if (PAIR) {
    const int c = i & 1, q = i >> 1;
    const int b = q % B, fl = (q / B) % t.nf, kl = q / B / t.nf;
    return ((long long)((t.k0 + kl) * C + c) * F + t.f0 + fl) * B + b;
  }
  const int b = i % B, q = i / B;
  const int fl = q % t.nf, kc = q / t.nf;
  return ((long long)(t.k0 * C + kc) * F + t.f0 + fl) * B + b;
}

// Zero tile t's accumulators and add rows [lo, hi) into them: positions of
// `rows` (grouped ids) or rows themselves; with read_slot a row's slot is
// read and rows outside the tile's slots skipped. Ends synchronised.
template <typename V, bool MERGE, bool PAIR>
__device__ __forceinline__ void sweep_tile(
    typename AccOf<V>::T* sh, const Tile& t, const uint8_t* __restrict__ X,
    const V* __restrict__ vals, const int* __restrict__ slot,
    const int* __restrict__ rows, bool read_slot, long long lo, long long hi,
    long long N, int C, int B) {
  typedef typename AccOf<V>::T A;
  const int fb = t.nf * B;               // cells of one (slot, channel)
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
    // cell (kl, fl, b) of [nk][C][nf][B], or pair (kl, fl, b) of
    // [nk][nf][B][2] with PAIR
    const int base = PAIR ? kl * fb : kl * C * fb;
    for (int fl = 0; fl < t.nf; ++fl) {
      const int b = ok ? X[(long long)(t.f0 + fl) * N + r] : B;
      const int idx = PAIR ? (base + fl * B + b) * 2 : base + fl * B + b;
      if (MERGE)
        merged_add<A, PAIR>(sh, idx, v, C, fb, b < B, lane);
      else if (b < B)
        cell_add<A, PAIR>(sh, idx, v, C, fb);
    }
  }
  __syncthreads();
}

// Block (tile, piece): each tile's rows are cut into `pieces` even pieces
// and its block of piece j sweeps piece j. Grouped rows (rows != null): per
// feature tile, the R = offsets[K] grouped rows make at most `segs` pieces
// of at least min_rows rows, and each slot tile takes pieces in proportion
// to its rows, so a wave's large and small children cost alike and no
// block crosses a tile's edge; block p of feature tile ft finds its (slot
// tile, piece) by walking the tiles' piece counts. Otherwise each
// tile sweeps [0, N) in `segs` pieces. A tile of one piece writes its
// cells to the output; else each block adds its nonzero cells into the f64
// accumulators in global memory and the last block of the tile (a
// completion counter) rounds the tile to f32.
template <typename V, bool MERGE, bool PAIR>
__global__ void __launch_bounds__(LGBT_THREADS, LGBT_TILE_BLOCKS_PER_SM)
hist_tiles_kernel(const uint8_t* __restrict__ X, const V* __restrict__ vals,
                  const int* __restrict__ slot, const int* __restrict__ rows,
                  const int* __restrict__ offsets,
                  typename AccOf<V>::T* __restrict__ acc,
                  typename OutOf<V>::T* __restrict__ out,
                  unsigned* __restrict__ counters, long long N, int F, int C,
                  int K, int B, int spt, int fpt, int nft, int segs,
                  int min_rows) {
  typedef typename AccOf<V>::T A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  __shared__ long long walk[4];          // slot tile (-1: none), piece,
                                         // pieces, rows of the slot tile
  A* sh = reinterpret_cast<A*>(smem_raw);
  int tile;
  long long lo, hi, pieces = 1;
  if (rows) {
    const int ft = blockIdx.x % nft, nst = (K + spt - 1) / spt;
    const long long R = offsets[K];
    // the tiles' rounding up adds at most nst pieces: one wave in all
    const long long P = max(1LL, min((long long)segs - nst, R / min_rows));
    const long long target = max(1LL, (R + P - 1) / P);
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
  const Tile t = make_tile(tile / nft, tile % nft, K, F, spt, fpt);
  if (!slot && t.k0 > 0) hi = lo;        // without slots every row is in 0
  const int cells = t.nk * C * t.nf * B;
  sweep_tile<V, MERGE, PAIR>(sh, t, X, vals, slot, rows,
                             slot && (!rows || t.nk > 1), lo, hi, N, C, B);
  if (pieces == 1) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x)
      out[tile_global<PAIR>(t, i, C, F, B)] = (typename OutOf<V>::T)sh[i];
    return;
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    if (sh[i] != (A)0)
      atomicAdd(acc + tile_global<PAIR>(t, i, C, F, B), sh[i]);
  if (!OutOf<V>::kRound) return;         // int32: acc is the output
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + tile, 1u) == (unsigned)(pieces - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const long long g = tile_global<PAIR>(t, i, C, F, B);
    out[g] = (typename OutOf<V>::T)__ldcg(acc + g);
  }
}

template <typename V, bool MERGE, bool PAIR>
static void launch_tiles(const uint8_t* X, const V* vals, const int* slot,
                         const int* rows, const int* offsets,
                         typename AccOf<V>::T* acc,
                         typename OutOf<V>::T* out, unsigned* counters,
                         long long N, int F, int C, int K, int B, int spt,
                         int fpt, int nst, int nft, int segs, int min_rows,
                         cudaStream_t st) {
  const size_t smem =
      (size_t)spt * C * fpt * B * sizeof(typename AccOf<V>::T);
  if (smem + 1024 > 48 * 1024)          // the static `last` flag rides along
    cudaFuncSetAttribute(hist_tiles_kernel<V, MERGE, PAIR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  hist_tiles_kernel<V, MERGE, PAIR>
      <<<rows ? nft * (segs + nst) : nst * nft * segs, LGBT_THREADS, smem,
         st>>>(
          X, vals, slot, rows, offsets, acc, out, counters, N, F, C, K, B,
          spt, fpt, nft, segs, min_rows);
}

template <typename V, bool PAIR>
static void launch(const uint8_t* X, const V* vals, const int* slot,
                   const int* rows, const int* offsets,
                   typename AccOf<V>::T* acc, typename OutOf<V>::T* out,
                   unsigned* counters, long long N, int F, int C, int K,
                   int B, int spt, int fpt, int nst, int nft, int segs,
                   int min_rows, int merge, cudaStream_t st) {
  if (merge)
    launch_tiles<V, true, PAIR>(X, vals, slot, rows, offsets, acc, out,
                                counters, N, F, C, K, B, spt, fpt, nst, nft,
                                segs, min_rows, st);
  else
    launch_tiles<V, false, PAIR>(X, vals, slot, rows, offsets, acc, out,
                                 counters, N, F, C, K, B, spt, fpt, nst, nft,
                                 segs, min_rows, st);
}

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
  if (direct) {
    const long long n = (long long)K * C * F * B;
    const int blocks = lgbt_grid(
        N, num_sms,
        K == 1 ? lgbt_smem_blocks_per_sm(n * (vals_int8 ? 4 : 8)) : 8);
    if (vals_int8) {
      cudaMemsetAsync(out, 0, n * sizeof(int), st);
      launch_direct<int8_t>((const uint8_t*)X, (const int8_t*)vals,
                            (const int*)slot, (int*)out, N, F, C, K, B,
                            blocks, st);
    } else {
      cudaMemsetAsync(acc, 0, n * sizeof(double), st);
      launch_direct<float>((const uint8_t*)X, (const float*)vals,
                           (const int*)slot, (double*)acc, N, F, C, K, B,
                           blocks, st);
      acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
          (const double*)acc, (float*)out, n);
    }
    return (int)cudaGetLastError();
  }
  const int* rows = nullptr;
  const int* offsets = nullptr;
  if (group_warps > 0) {
    const int W = group_warps;
    int* wcnt = (int*)scratch;
    int* totals = wcnt + (long long)K * W;
    int* offs = totals + K;
    int* ids = offs + K + 1;
    const int blocks = (W + LGBT_THREADS / 32 - 1) / (LGBT_THREADS / 32);
    const size_t smem = (size_t)(LGBT_THREADS / 32) * K * sizeof(int);
    group_pass_kernel<false><<<blocks, LGBT_THREADS, smem, st>>>(
        (const int*)slot, N, K, W, wcnt, totals, offs, ids);
    group_scan_kernel<<<K, 1024, 0, st>>>(wcnt, W, totals);
    group_pass_kernel<true><<<blocks, LGBT_THREADS, smem, st>>>(
        (const int*)slot, N, K, W, wcnt, totals, offs, ids);
    rows = ids;
    offsets = offs;
  }
  const long long n = (long long)K * C * F * B;
  if (rows || segs > 1)
    cudaMemsetAsync(vals_int8 ? out : acc, 0,
                    vals_int8 ? n * sizeof(int)
                              : (n + (nst * nft + 1) / 2) * sizeof(double),
                    st);
  if (rows && !vals_int8) cudaMemsetAsync(out, 0, n * sizeof(float), st);
  if (vals_int8) {
    launch<int8_t, false>((const uint8_t*)X, (const int8_t*)vals,
                          (const int*)slot, rows, offsets, (int*)out,
                          (int*)out, nullptr, N, F, C, K, B, spt, fpt, nst,
                          nft, segs, min_rows, merge, st);
  } else {
    unsigned* counters = acc ? (unsigned*)((double*)acc + n) : nullptr;
    if (pair && C == 2)
      launch<float, true>((const uint8_t*)X, (const float*)vals,
                          (const int*)slot, rows, offsets, (double*)acc,
                          (float*)out, counters, N, F, C, K, B, spt, fpt,
                          nst, nft, segs, min_rows, merge, st);
    else
      launch<float, false>((const uint8_t*)X, (const float*)vals,
                           (const int*)slot, rows, offsets, (double*)acc,
                           (float*)out, counters, N, F, C, K, B, spt, fpt,
                           nst, nft, segs, min_rows, merge, st);
  }
  return (int)cudaGetLastError();
}
