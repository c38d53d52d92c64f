// The general fused wave: membership from precomputed decision bits (a
// pending relabel first, then this wave's), the smaller-child slot
// histogram over any number of storage columns, then the best-split search
// of both children of every candidate.
//
// Replaces lightgbm_tpu/ops/grow_fused.py::wave_pass_fused_tiled_pallas
// (pallas_call at :656). The TPU kernel walks feature tiles of
// `fused_feature_tile` columns, because one tile's accumulator and parent
// slab must fit in VMEM, and merges the tiles' scan records by their raw
// gains (merge_tile_records). Here the scan (split_scan.cuh) gives every
// (child, feature) a warp and reduces each child's winner across them, so
// there is nothing to merge. `fused_feature_tile` keeps only its meaning
// for the wave width (the K cap of ops/grow_wave.py:fused_kcap), which
// decides the trees.
//
// Decision bits, dec [Kd, N] uint8 per (entry k, row): bit 0 = goes left
// under this wave's applied entry k, bit 1 = lands in candidate k's
// smaller child, bit 2 = goes left under the pending (deferred) applied
// entry k of the previous applies-only wave. The work of a wave:
//   1. the membership pass (fused_member_kernel): each block builds three
//      leaf -> entry maps in shared memory (pending, applied, candidate;
//      16-bit, 24 KB together), marking a leaf named by two active entries
//      so that it matches neither (the TPU kernel's `inP == 1` / `inA ==
//      1` rule); a row reads at most three dec bytes and writes its new
//      leaf id and its slot (the candidate whose smaller child it lands
//      in, else -1); past LGBT_LEAF_CAP leaves the three maps live in
//      global memory instead (wave_table.cuh), built by a one-block
//      prologue and cleared by an epilogue;
//   2. the smaller children's slot histogram, by the tiled accumulation
//      engine of hist_tiles.cuh over the uniform storage, on kernel #1's
//      plan (ops/histogram_cuda.py:plan_hist_tiles): rows grouped by slot,
//      (slot, feature) tiles of <= 48 KB, the tiles' last blocks rounding
//      to f32; or, for little work, the direct sweep, whose f64 sums the
//      scan rounds as it reads them;
//   3. the scan of every child (split_scan.cuh).
// Steps 2 and 3 are the tail this kernel shares with #9 (fused_tail.cuh).
// The first version accumulated in the membership sweep itself, a row per
// thread into a private copy of the whole [K, 2, F, B] histogram (one
// block per SM at the Criteo root) or into global f64 atomics in L2, then
// ran a rounding launch and a scan of one thread per feature.
//
// Quantized gradients: int8 value channels accumulate exactly in int32,
// and the scan subtracts parent - small in int32 before it descales
// (grow_fused.py:437-439; c * (a - b) is not c * a - c * b in f32).
//
// Bound: bytes. A row reads its leaf id and at most three dec bytes and
// writes its new leaf id; a row of a smaller child also reads its F bins
// and C values. The engine's shared-memory adds limit the histogram as
// they limit hist_slots.cu; the parent histograms (K * 2 * F * B) are read
// once by the scan.
#include <type_traits>

#include "fused_tail.cuh"
#include "wave_table.cuh"

#define LGBT_MAP_NONE 0xFFFF
#define LGBT_MAP_DUP 0xFFFE

// map[leaf] = k for the active entries k < n of leaves (-1 = inactive); a
// leaf named twice becomes LGBT_MAP_DUP
__device__ __forceinline__ void lgbt_map_entries16(
    const int* __restrict__ leaves, int n, int leaf_cap,
    unsigned short* map) {
  if (threadIdx.x < LGBT_T_ENTRIES && threadIdx.x < n) {
    const int leaf = leaves[threadIdx.x];
    if (leaf >= 0 && leaf < leaf_cap) {
      const unsigned short old =
          atomicCAS(map + leaf, (unsigned short)LGBT_MAP_NONE,
                    (unsigned short)threadIdx.x);
      // from NONE a slot changes once, then only to DUP
      if (old != LGBT_MAP_NONE)
        atomicCAS(map + leaf, old, (unsigned short)LGBT_MAP_DUP);
    }
  }
}

__device__ __forceinline__ int lgbt_entry16(const unsigned short* map,
                                            int leaf, int leaf_cap) {
  if ((unsigned)leaf >= (unsigned)leaf_cap) return -1;
  const int v = map[leaf];
  return v < LGBT_T_ENTRIES ? v : -1;
}

// the entry of `leaf` in a shared 16-bit map
struct Map16 {
  const unsigned short* m;
  int cap;
  __device__ __forceinline__ int operator()(int leaf) const {
    return lgbt_entry16(m, leaf, cap);
  }
};

// The membership pass: lor_out[r] = the row's leaf after the pending and
// the applied decisions, slot[r] = its candidate if it lands in that
// candidate's smaller child, else -1. GM: the three maps in global memory
// (gmap: pending, applied, candidates, L words each; wave_table.cuh, rule
// 1), else in the block's shared memory.
template <bool GM>
__global__ void __launch_bounds__(LGBT_THREADS)
fused_member_kernel(const uint8_t* __restrict__ dec,
                    const int* __restrict__ lor_in,
                    const int* __restrict__ table,
                    const int* __restrict__ pend,
                    const int* __restrict__ pend_nl0,
                    int* __restrict__ lor_out, int* __restrict__ slot,
                    long long N, int K, int Kd, int leaf_cap,
                    const int* __restrict__ gmap) {
  constexpr int kCap = GM ? 2 : LGBT_LEAF_CAP;
  __shared__ unsigned short pend_of[kCap], app_of[kCap], cand_of[kCap];
  if (!GM) {
    for (int i = threadIdx.x; i < leaf_cap; i += blockDim.x)
      pend_of[i] = app_of[i] = cand_of[i] = LGBT_MAP_NONE;
    __syncthreads();
    lgbt_map_entries16(pend, Kd, leaf_cap, pend_of);
    lgbt_map_entries16(table, Kd, leaf_cap, app_of);
    lgbt_map_entries16(table + 7 * LGBT_T_ENTRIES, K, leaf_cap, cand_of);
    __syncthreads();
  }
  typedef typename std::conditional<GM, LgbtMap<true>, Map16>::type M;
  typedef typename std::conditional<GM, const int*,
                                    const unsigned short*>::type P;
  const M pmap = {GM ? (P)gmap : (P)pend_of, leaf_cap};
  const M amap = {GM ? (P)(gmap + leaf_cap) : (P)app_of, leaf_cap};
  const M cmap = {GM ? (P)(gmap + 2 * (long long)leaf_cap) : (P)cand_of,
                  leaf_cap};
  const int nl0 = table[15 * LGBT_T_ENTRIES], pnl0 = *pend_nl0;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    int leaf = lor_in[r];
    const int kp = pmap(leaf);
    if (kp >= 0 && ((dec[(long long)kp * N + r] >> 2) & 1) == 0)
      leaf = pnl0 + kp;
    const int ka = amap(leaf);
    if (ka >= 0 && (dec[(long long)ka * N + r] & 1) == 0) leaf = nl0 + ka;
    lor_out[r] = leaf;
    const int kc = cmap(leaf);
    slot[r] = kc >= 0 && ((dec[(long long)kc * N + r] >> 1) & 1) ? kc : -1;
  }
}

// X [F, N] uint8; vals [2, N] f32 (vals_int8 = 0) or int8; dec [Kd, N]
// uint8; lor_in / lor_out [N] int32; table [16, 128] int32 of which rows 0
// (applied leaves), 7 (candidate leaves) and 15 (nl0) are read, entries at
// Kd (applied) or K (candidates) and above inactive; pend [128] int32 the
// pending applied leaves (-1 = inactive; entries at Kd and above unread)
// and pend_nl0 [1] int32 their first new leaf id. Every per-tree and
// per-wave value is read from device memory, so a captured graph replays
// each wave's own. The histogram plan (spt, fpt, nst,
// nft, segs, min_rows, merge, pair, direct, group_warps) is kernel #1's
// (lgbt_hist_slots, hist_slots.cu), and so are out and acc: out [K, 2, F,
// B] f32 or int32 written here, acc f64 ([K * 2 * F * B] sums, then the
// tiles' completion counters; f32 only). scratch: [N] int32 slots, then
// the grouping's scratch when group_warps > 0. parent [K, 2, F, B] f32 or
// int32 (descaled in the scan by scale [2] f32, the grad and hess factors;
// null with f32 vals). scal / fmeta / fmask /
// rec as lgbt_split_scan_kernel, scan_scratch its [2K] keys and [2K]
// counters. gmap: null for leaf_cap <= LGBT_LEAF_CAP (the shared maps),
// else the global maps' buffer, every word LGBT_GMAP_NONE, left so
// (wave_table.cuh).
extern "C" int lgbt_wave_pass_fused_tiled(
    const void* X, const void* vals, int vals_int8, const void* dec,
    const void* lor_in, const void* table, const void* pend,
    const void* pend_nl0,
    void* lor_out, void* out, void* acc, void* scratch, const void* parent,
    const void* scal, const void* fmeta, const void* fmask,
    int fmask_stride, void* rec, void* scan_scratch, long long N, int F,
    int K, int B, int Kd, int leaf_cap, void* gmap, int spt, int fpt,
    int nst, int nft,
    int segs, int min_rows, int merge, int pair, int direct,
    int group_warps, const void* scale, float min_data_slack,
    float min_hess, float l1, float l2, float max_delta_step,
    float path_smooth, float min_gain, int use_mds, int use_ps, int num_sms,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const LgbtSplitHp hp =
      lgbt_make_hp(min_data_slack, min_hess, l1, l2, max_delta_step,
                   path_smooth, min_gain, use_mds, use_ps);
  int* slot = (int*)scratch;
  const int grid = lgbt_grid(N, num_sms, 8);
  const int* t = (const int*)table;
  if (!gmap) {
    fused_member_kernel<false><<<grid, LGBT_THREADS, 0, st>>>(
        (const uint8_t*)dec, (const int*)lor_in, t, (const int*)pend,
        (const int*)pend_nl0, (int*)lor_out, slot, N, K, Kd, leaf_cap,
        nullptr);
  } else {
    const int* cand = t + 7 * LGBT_T_ENTRIES;
    lgbt_gmap_launch((int*)gmap, leaf_cap, (const int*)pend, Kd, t, Kd, cand,
                     K, 1, st);
    fused_member_kernel<true><<<grid, LGBT_THREADS, 0, st>>>(
        (const uint8_t*)dec, (const int*)lor_in, t, (const int*)pend,
        (const int*)pend_nl0, (int*)lor_out, slot, N, K, Kd, leaf_cap,
        (const int*)gmap);
    lgbt_gmap_launch((int*)gmap, leaf_cap, (const int*)pend, Kd, t, Kd, cand,
                     K, 2, st);
  }
  const LgbtTilePlan p = {spt,  fpt,   nst,  nft,    segs,
                          min_rows, merge, pair, direct, group_warps};
  if (vals_int8)
    lgbt_fused_hist_scan<int8_t>(
        (const uint8_t*)X, (const int8_t*)vals, slot, slot + N, (int*)out,
        nullptr, (const int*)parent, (const float*)scal, (const int*)fmeta,
        (const uint8_t*)fmask, fmask_stride, (float*)rec, scan_scratch, N, F,
        K, B, p, false, (const float*)scale, hp, num_sms, st);
  else
    lgbt_fused_hist_scan<float>(
        (const uint8_t*)X, (const float*)vals, slot, slot + N, (float*)out,
        (double*)acc, (const float*)parent, (const float*)scal,
        (const int*)fmeta, (const uint8_t*)fmask, fmask_stride, (float*)rec,
        scan_scratch, N, F, K, B, p, false, nullptr, hp, num_sms, st);
  return (int)cudaGetLastError();
}
