// The wave table shared by wave_pass.cu, wave_pass_fused.cu (through the
// membership pass of wave_member.cuh) and wave_relabel.cu.
//
// The caller hands over the JAX package's 16-row semantic table [16, 128]
// int32 (lightgbm_tpu/ops/histogram_pallas.py:379-381):
//   0 applied leaf (-1 = inactive)  1 feat  2 thr  3 default_left
//   4 missing_type  5 default_bin  6 num_bins
//   7 candidate leaf (-1 = inactive)  8-13 as 1-6  14 smaller_is_left
//   15 first new leaf id (nl0, read from column 0).
// Each block packs every entry into one int32 with the TPU kernel's bit
// layout (histogram_pallas.py:387-389, :405-406):
//   feat&31 | thr<<5 | dl<<13 | miss_bin<<14 | sil<<23
// and decodes with the same masks, so odd inputs resolve exactly as on the
// TPU. miss_bin pre-resolves the missing test: default_bin for
// MissingType::Zero, num_bins-1 for MissingType::NaN, else 0x1FF (never a
// uint8 bin). Leaf ids map to their entry through a per-block shared table
// of LGBT_LEAF_CAP entries, so a row finds its entry with one lookup
// instead of comparing against all 128. A leaf named by several active
// entries maps to the lowest of them, the first match of the plain
// versions (ops/histogram_cuda.py:_entry_of), whatever order the threads
// write in; the TPU kernel's masked sum assumes a leaf is named once, and
// the grower never names one twice.
//
// Past the cap (L > LGBT_LEAF_CAP leaves; the JAX package has no cap) the
// maps live in global memory: up to three maps of L int32 words each
// (gmap + m * L), which a booster allocates once and fills with
// LGBT_GMAP_NONE (ops/histogram_cuda.py:new_leaf_map).
// A prologue launch of one block (lgbt_gmap_kernel) writes the wave's at
// most 128 entries a map, the main kernel reads a leaf's word through
// __ldg (at L = 131072 a map is 512 KB, which stays in the 50 MB L2), and
// an epilogue launch of the same block clears the words it wrote, not L
// words a wave. The lowest-entry rule is an atomicMin on the leaf's word;
// the rule of wave_apply.cu and wave_pass_fused_tiled.cu (a leaf named
// twice matches neither) a compare-and-swap from NONE, then DUP. Every
// launch is on the caller's stream and reads its leaves from device
// memory, so a captured graph replays each wave's own. A sorted entry list
// in shared memory with a binary search a row was the alternative: it
// costs seven dependent shared loads a lookup where the global map costs
// one L2 load, and it needs its own sort a block.
#pragma once

#include "common.cuh"

#define LGBT_T_ENTRIES 128
#define LGBT_GMAP_NONE 0x7FFFFFFF   // a global map's unset word
#define LGBT_GMAP_DUP 0x7FFFFFFE    // a leaf named twice (rule 1)
#define LGBT_GMAP_MAPS 3            // maps a global buffer holds

__device__ __forceinline__ int lgbt_pack_entry(const int* __restrict__ t,
                                               int row0, int k, int sil) {
  const int feat = t[(row0 + 0) * LGBT_T_ENTRIES + k];
  const int thr = t[(row0 + 1) * LGBT_T_ENTRIES + k];
  const int dl = t[(row0 + 2) * LGBT_T_ENTRIES + k];
  const int mt = t[(row0 + 3) * LGBT_T_ENTRIES + k];
  const int db = t[(row0 + 4) * LGBT_T_ENTRIES + k];
  const int nb = t[(row0 + 5) * LGBT_T_ENTRIES + k];
  const int mb = mt == 1 ? db : (mt == 2 ? nb - 1 : 0x1FF);
  const unsigned p = ((unsigned)feat & 31u) | ((unsigned)thr << 5) |
                     ((unsigned)dl << 13) | ((unsigned)mb << 14) |
                     ((unsigned)sil << 23);
  return (int)p;
}

// go-left of row r under a packed entry; features past F read bin 0, as
// the TPU kernel's zero-padded 32-row block does.
__device__ __forceinline__ bool lgbt_go_left(int p, const uint8_t* __restrict__ X,
                                             long long N, int F, long long r) {
  const unsigned u = (unsigned)p;
  const int feat = (int)(u & 31u);
  const int thr = (int)((u >> 5) & 0xFFu);
  const bool dl = ((u >> 13) & 1u) != 0;
  const int mb = (int)((u >> 14) & 0x1FFu);
  const int col = feat < F ? (int)X[(long long)feat * N + r] : 0;
  return col == mb ? dl : (col <= thr);
}

// map[leaf] = min(map[leaf], k) for a byte map whose unset entries are -1:
// a compare-and-swap on the aligned word holding the byte.
__device__ __forceinline__ void lgbt_map_min(signed char* map, int leaf,
                                             int k) {
  const unsigned sh = 8u * ((unsigned)(uintptr_t)(map + leaf) & 3u);
  unsigned* w = (unsigned*)((uintptr_t)(map + leaf) & ~(uintptr_t)3);
  unsigned old = *w;
  while (true) {
    const int cur = (signed char)((old >> sh) & 0xFFu);
    if (cur >= 0 && cur <= k) return;
    const unsigned nw = (old & ~(0xFFu << sh)) | ((unsigned)k << sh);
    const unsigned prev = atomicCAS(w, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

// Block prologue: packed entries and leaf -> entry maps in shared memory.
// Candidate entries past K are not mapped (the histogram width is K).
// Every load of the table is issued before the first barrier (the maps'
// leaves kept in registers across it), so the prologue waits for the
// table once.
__device__ __forceinline__ void lgbt_load_table(
    const int* __restrict__ t, int K, int leaf_cap, bool with_cand,
    int* app_p, int* cand_p, signed char* app_of, signed char* cand_of) {
  const int k = threadIdx.x;
  int la = -1, lc = -1;
  if (k < LGBT_T_ENTRIES) {
    la = t[k];
    if (with_cand && k < K) lc = t[7 * LGBT_T_ENTRIES + k];
    app_p[k] = lgbt_pack_entry(t, 1, k, 0);
    if (with_cand)
      cand_p[k] = lgbt_pack_entry(t, 8, k, t[14 * LGBT_T_ENTRIES + k] & 1);
  }
  for (int i = threadIdx.x; i < leaf_cap; i += blockDim.x) {
    app_of[i] = -1;
    if (with_cand) cand_of[i] = -1;
  }
  __syncthreads();
  if (la >= 0 && la < leaf_cap) lgbt_map_min(app_of, la, k);
  if (lc >= 0 && lc < leaf_cap) lgbt_map_min(cand_of, lc, k);
  __syncthreads();
}

// The applied split of row r's leaf, if any: returns the new leaf id (the
// right child nl0 + entry for rows that go right, else unchanged).
template <class Map>
__device__ __forceinline__ int lgbt_relabel(int lor, const int* app_p,
                                            Map app_of, int nl0,
                                            const uint8_t* __restrict__ X,
                                            long long N, int F, long long r) {
  const int ka = app_of(lor);
  if (ka >= 0 && !lgbt_go_left(app_p[ka], X, N, F, r)) return nl0 + ka;
  return lor;
}

// The global-map prologue / epilogue, one block of LGBT_GMAP_MAPS *
// LGBT_T_ENTRIES threads: thread (m, k) takes entry k < n_m of the leaves
// `l_m` (null: no map m) and, for a leaf in [0, L), sets map m's word.
// mode 0: the lowest entry (atomicMin); 1: NONE -> k, a second entry DUP;
// 2: back to NONE (the epilogue, on the same leaves).
static __global__ void __launch_bounds__(LGBT_GMAP_MAPS * LGBT_T_ENTRIES)
lgbt_gmap_kernel(int* __restrict__ gmap, int L, const int* l0, int n0,
                 const int* l1, int n1, const int* l2, int n2, int mode) {
  const int m = threadIdx.x / LGBT_T_ENTRIES, k = threadIdx.x % LGBT_T_ENTRIES;
  const int* l = m == 0 ? l0 : (m == 1 ? l1 : l2);
  const int n = m == 0 ? n0 : (m == 1 ? n1 : n2);
  if (!l || k >= n) return;
  const int leaf = l[k];
  if (leaf < 0 || leaf >= L) return;
  int* w = gmap + (long long)m * L + leaf;
  if (mode == 0) {
    atomicMin(w, k);
  } else if (mode == 1) {
    if (atomicCAS(w, LGBT_GMAP_NONE, k) != LGBT_GMAP_NONE)
      atomicExch(w, LGBT_GMAP_DUP);
  } else {
    *w = LGBT_GMAP_NONE;
  }
}

static inline void lgbt_gmap_launch(int* gmap, int L, const int* l0, int n0,
                                    const int* l1, int n1, const int* l2,
                                    int n2, int mode, cudaStream_t st) {
  lgbt_gmap_kernel<<<1, LGBT_GMAP_MAPS * LGBT_T_ENTRIES, 0, st>>>(
      gmap, L, l0, n0, l1, n1, l2, n2, mode);
}

// A leaf's entry: the shared byte map of a block (L <= LGBT_LEAF_CAP) or
// a global int map; -1 for a leaf outside [0, cap) or with no entry.
template <bool GM> struct LgbtMap;
template <> struct LgbtMap<false> {
  const signed char* m;
  int cap;
  __device__ __forceinline__ int operator()(int leaf) const {
    return (unsigned)leaf < (unsigned)cap ? m[leaf] : -1;
  }
};
template <> struct LgbtMap<true> {
  const int* m;
  int cap;
  __device__ __forceinline__ int operator()(int leaf) const {
    if ((unsigned)leaf >= (unsigned)cap) return -1;
    const int v = __ldg(m + leaf);
    return v < LGBT_T_ENTRIES ? v : -1;
  }
};

template <bool GM>
__device__ __forceinline__ LgbtMap<GM> lgbt_map(const signed char* s,
                                                const int* g, int cap);
template <>
__device__ __forceinline__ LgbtMap<false> lgbt_map<false>(
    const signed char* s, const int* g, int cap) {
  return {s, cap};
}
template <>
__device__ __forceinline__ LgbtMap<true> lgbt_map<true>(
    const signed char* s, const int* g, int cap) {
  return {g, cap};
}
