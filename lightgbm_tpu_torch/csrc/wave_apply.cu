// Decide-and-apply pass of the wide / categorical / EFB wave route: each
// row's applied split and candidate split are decided here, from the
// wave's split records, and no [Kd, N] decision matrix is built.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_apply_pallas
// (`_wave_apply_kernel`, pallas_call at :658) together with the decision
// build that feeds it (lightgbm_tpu/ops/grow_wave.py:896-929
// `dec_go_left`). The TPU computes every row's go-left bit under every
// entry in dense compare-select chains, because gathers from small tables
// crawl there (grow_wave.py:937-940), and the membership kernel reads one
// bit per row from that matrix. Here a row looks its leaf up in a
// leaf -> entry map in shared memory, reads the one storage byte its
// entry's feature needs and tests it, the per-row form of the TPU's
// `table_go_left` (grow_wave.py:931-995).
//
// Inputs: X [C, N] storage columns (uint8, or uint16 past 256 bins, where
// EFB is off), leaf_of_row [N], the [16, 128]
// wave table (wave_table.cuh: rows 0-6 applied leaf, feature, threshold,
// default_left, missing_type, default_bin, num_bins; rows 7-14 the same
// for the candidates plus smaller_is_left; row 15 nl0) with full int32
// feature ids, the entries' categorical flags and bitsets ([2, 128,
// 1 + W] int32: flag, then W 32-bit words; null when the data has no
// categorical feature), and for EFB storage the [4, F] bundle map
// (column, offset (-1 = raw singleton), num_bin, default bin of each
// feature; null: feature f is column f). Outputs: new_lor = nl0 + k for
// the rows of applied entry k that go right (else unchanged), and slot =
// k for the rows whose new leaf is candidate k's and that land in its
// smaller child (go-left == smaller_is_left), else -1.
//
// Per row, the rules of dec_go_left: the feature clamps to [0, F); a
// bundled feature's bin is unpacked from its column (FastFeatureBundling's
// inverse, dataset.cpp:251), a raw singleton read as it is; a categorical
// entry tests bit `bin` of its bitset; a numeric one sends its missing bin
// (default_bin under MissingType::Zero, num_bins - 1 under NaN) to
// default_left and the rest to `bin <= threshold`. Entries at Kd or above
// are inactive, and a leaf named by two active entries matches neither,
// as the TPU kernel's `inA == 1` / `inC == 1` rule has it.
//
// Bound: bytes. A row reads its leaf id (4 B), at most one storage byte
// for its applied test and one for its candidate test, and writes its new
// leaf id and slot (8 B). The storage bytes are scattered (neighbouring
// rows sit in different leaves), but a Criteo-sized X (2^20 x 39, 41 MB)
// stays in the 50 MB L2, so they are L2 sectors, not DRAM ones. Design:
// each block stages both entry tables (one 16-byte record each), the
// bitsets of the active entries and the two leaf maps once, then runs a
// persistent grid-stride loop (four blocks an SM) in which a thread takes
// four rows a grid stride apart, so that four rows' chains of dependent
// loads are in flight together. Past 256 bins (uint16 storage) a
// categorical bitset has up to cat_words(B) words (ops/grow.py), more than
// the staged table holds: that instance reads an entry's word from `cats`
// in global memory (a few KB, in L1 and L2), one load a categorical test.
// Past LGBT_LEAF_CAP leaves the two maps would not fit a block's shared
// memory: they live in global memory (wave_table.cuh), built by a
// one-block prologue and cleared by an epilogue, and a row reads its
// map words through __ldg.
#include <type_traits>

#include "wave_table.cuh"

#define LGBT_AP_ENTRIES 128   // LGBT_T_ENTRIES: entries of a wave table
#define LGBT_AP_MAX_W 8       // bitset words staged (bins <= 256)
#define LGBT_AP_ILP 4         // rows a thread carries at once
#define LGBT_DUP (-2)         // leaf named by more than one active entry

// An entry's split as one 16-byte record (bins of type T):
//   x column of X to read
//   y thr+1 (17 bits, thr clamped to [-1, max T]) | default_left << 17 |
//     is_cat << 18 | smaller_is_left << 19
//   z miss_bin+1 (17 bits, 0 = none) | (bundle offset + 1) << 17 (0 = the
//     column's bin as it is)
//   w bundle num_bin | bundle default bin << 16
template <typename T>
__device__ __forceinline__ int4 ap_entry(const int* __restrict__ t, int row0,
                                         int k, int sil, int is_cat,
                                         const int* __restrict__ bundle,
                                         int F) {
  const int tmax = (int)(T)~(T)0;
  const int feat = t[(row0 + 0) * LGBT_AP_ENTRIES + k];
  const int thr = t[(row0 + 1) * LGBT_AP_ENTRIES + k];
  const int dl = t[(row0 + 2) * LGBT_AP_ENTRIES + k] != 0;
  const int mt = t[(row0 + 3) * LGBT_AP_ENTRIES + k];
  const int db = t[(row0 + 4) * LGBT_AP_ENTRIES + k];
  const int nb = t[(row0 + 5) * LGBT_AP_ENTRIES + k];
  int mb = mt == 1 ? db : (mt == 2 ? nb - 1 : -1);
  if (mb < 0 || mb > tmax) mb = -1;    // no bin of type T equals it
  const int f = min(max(feat, 0), F - 1);
  const int off = bundle ? bundle[F + f] : -1;
  int4 e;
  e.x = bundle ? bundle[f] : f;
  e.y = (min(max(thr, -1), tmax) + 1) | (dl << 17) | ((is_cat != 0) << 18) |
        ((sil & 1) << 19);
  e.z = (mb + 1) | ((off + 1) << 17);
  e.w = bundle ? ((bundle[2 * F + f] & 0xFFFF) | (bundle[3 * F + f] << 16))
               : 0;
  return e;
}

// the smaller_is_left bit of an entry record
__device__ __forceinline__ bool ap_sil(int4 e) { return (e.y >> 19) & 1; }

// go-left of a row of bin `bin` under entry e; a categorical entry tests
// bit `bin` of its W-word bitset: the staged `bits` (STAGED), or the
// entry's words `gbits` in global memory
template <bool STAGED>
__device__ __forceinline__ bool ap_go_left(int4 e, const unsigned* bits,
                                           const int* __restrict__ gbits,
                                           int W, int bin) {
  const int off = (e.z >> 17) - 1;
  if (off >= 0) {
    const int nbf = e.w & 0xFFFF, dbf = e.w >> 16;
    const int rb = bin - off;
    bin = (rb >= 0 && rb < nbf - 1) ? rb + (rb >= dbf) : dbf;
  }
  const int y = e.y;
  if ((y >> 18) & 1) {
    const int wi = min(bin >> 5, W - 1);
    const unsigned word = STAGED ? bits[wi] : (unsigned)__ldg(gbits + wi);
    return (word >> (bin & 31)) & 1u;
  }
  const int thr = (y & 0x1FFFF) - 1, mb = (e.z & 0x1FFFF) - 1;
  return bin == mb ? ((y >> 17) & 1) != 0 : bin <= thr;
}

// map[leaf] = k for the active entries k < Kd of the leaf row `t`; a leaf
// named twice becomes LGBT_DUP.
__device__ __forceinline__ void ap_map_entries(const int* __restrict__ t,
                                               int Kd, int leaf_cap,
                                               int* map) {
  const int k = threadIdx.x;
  if (k < LGBT_AP_ENTRIES && k < Kd) {
    const int leaf = t[k];
    if (leaf >= 0 && leaf < leaf_cap) {
      const int old = atomicCAS(map + leaf, -1, k);
      if (old != -1) atomicExch(map + leaf, LGBT_DUP);
    }
  }
}

// the entry of `leaf` in an int map of the shared form (-1 none, LGBT_DUP)
struct ApSharedMap {
  const int* m;
  int cap;
  __device__ __forceinline__ int operator()(int leaf) const {
    return (unsigned)leaf < (unsigned)cap ? m[leaf] : -1;
  }
};

// T = uint8_t stages the bitsets (W <= LGBT_AP_MAX_W); uint16_t reads them
// from `cats`. GM: the two leaf maps in global memory (gmap, L words each;
// wave_table.cuh, rule 1), else in dynamic shared memory.
template <typename T, bool GM>
__global__ void __launch_bounds__(LGBT_THREADS)
wave_apply_kernel(const T* __restrict__ X,
                  const int* __restrict__ lor_in,
                  const int* __restrict__ table,
                  const int* __restrict__ cats, int W,
                  const int* __restrict__ bundle, int F,
                  int* __restrict__ lor_out, int* __restrict__ slot_out,
                  long long N, int Kd, int leaf_cap,
                  const int* __restrict__ gmap) {
  constexpr bool kStaged = sizeof(T) == 1;
  __shared__ int4 ent[2 * LGBT_AP_ENTRIES];   // applied, then candidates
  __shared__ unsigned bits[kStaged ? 2 * LGBT_AP_ENTRIES * LGBT_AP_MAX_W
                                   : 1];
  extern __shared__ int maps[];               // [2, leaf_cap], or none
  const int scap = GM ? 0 : leaf_cap;
  int* app_of = maps;
  int* cand_of = maps + scap;
  for (int i = threadIdx.x; i < 2 * scap; i += blockDim.x) maps[i] = -1;
  {
    // the active entries' records (the maps name no other)
    const int k = threadIdx.x;
    const int side = k / LGBT_AP_ENTRIES, j = k % LGBT_AP_ENTRIES;
    if (k < 2 * LGBT_AP_ENTRIES && j < Kd) {
      const int* c = cats ? cats + (long long)k * (1 + W) : nullptr;
      const int sil = side ? table[14 * LGBT_AP_ENTRIES + j] : 0;
      ent[k] = ap_entry<T>(table, side ? 8 : 1, j, sil, c ? c[0] : 0,
                           bundle, F);
      if (kStaged && c)
        for (int w = 0; w < W; ++w)
          bits[k * LGBT_AP_MAX_W + w] = (unsigned)c[1 + w];
    }
  }
  __syncthreads();
  if (!GM) {
    ap_map_entries(table, Kd, leaf_cap, app_of);
    ap_map_entries(table + 7 * LGBT_AP_ENTRIES, Kd, leaf_cap, cand_of);
    __syncthreads();
  }
  typedef typename std::conditional<GM, LgbtMap<true>, ApSharedMap>::type M;
  const M amap = {GM ? gmap : (const int*)app_of, leaf_cap};
  const M cmap = {GM ? gmap + leaf_cap : (const int*)cand_of, leaf_cap};

  const int nl0 = table[15 * LGBT_AP_ENTRIES];
  const long long S = (long long)gridDim.x * blockDim.x;
  for (long long r0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       r0 < N; r0 += LGBT_AP_ILP * S) {
    long long r[LGBT_AP_ILP];
    int leaf[LGBT_AP_ILP], k[LGBT_AP_ILP], bin[LGBT_AP_ILP];
#pragma unroll
    for (int i = 0; i < LGBT_AP_ILP; ++i) {
      r[i] = r0 + i * S;
      leaf[i] = r[i] < N ? lor_in[r[i]] : -1;
    }
    // the applied split: the row's entry, its byte, its test
#pragma unroll
    for (int i = 0; i < LGBT_AP_ILP; ++i) {
      k[i] = amap(leaf[i]);
      bin[i] = k[i] >= 0 ? X[(long long)ent[k[i]].x * N + r[i]] : 0;
    }
#pragma unroll
    for (int i = 0; i < LGBT_AP_ILP; ++i) {
      if (k[i] >= 0 &&
          !ap_go_left<kStaged>(ent[k[i]],
                               bits + (kStaged ? k[i] : 0) * LGBT_AP_MAX_W,
                               cats + (long long)k[i] * (1 + W) + 1, W,
                               bin[i]))
        leaf[i] = nl0 + k[i];
      if (r[i] < N) lor_out[r[i]] = leaf[i];
    }
    // the candidate split of the row's new leaf
#pragma unroll
    for (int i = 0; i < LGBT_AP_ILP; ++i) {
      k[i] = cmap(leaf[i]);
      bin[i] = k[i] >= 0 ? X[(long long)ent[LGBT_AP_ENTRIES + k[i]].x * N +
                             r[i]]
                         : 0;
    }
#pragma unroll
    for (int i = 0; i < LGBT_AP_ILP; ++i) {
      int s = -1;
      if (k[i] >= 0) {
        const int e = LGBT_AP_ENTRIES + k[i];
        const bool gl = ap_go_left<kStaged>(
            ent[e], bits + (kStaged ? e : 0) * LGBT_AP_MAX_W,
            cats + (long long)e * (1 + W) + 1, W, bin[i]);
        if (gl == ap_sil(ent[e])) s = k[i];
      }
      if (r[i] < N) slot_out[r[i]] = s;
    }
  }
}

// X [C, N] uint8 (bin16 = 0; cats W <= 8) or uint16 (bundle null), lor_in
// / lor_out / slot_out [N] int32, table [16, 128] int32, cats [2, 128,
// 1 + W] int32 or null, bundle [4, F] int32 or null (F: the features the
// table's ids index; C when null); 1 <= Kd <= 128; every leaf id that
// should match lies below leaf_cap. gmap: null for leaf_cap <=
// LGBT_LEAF_CAP (the maps in dynamic shared memory), else the global maps'
// buffer, every word LGBT_GMAP_NONE, left so (wave_table.cuh).
template <typename T>
static void ap_launch(const T* X, const int* lor_in, const int* table,
                      const int* cats, int W, const int* bundle, int F,
                      int* lor_out, int* slot_out, long long N, int Kd,
                      int leaf_cap, int* gmap, int grid, cudaStream_t st) {
  if (!gmap) {
    // the maps (at most 32 KB) and the static 12 KB stay under 48 KB
    const size_t smem = 2 * (size_t)leaf_cap * sizeof(int);
    wave_apply_kernel<T, false><<<grid, LGBT_THREADS, smem, st>>>(
        X, lor_in, table, cats, W, bundle, F, lor_out, slot_out, N, Kd,
        leaf_cap, nullptr);
    return;
  }
  const int* cand = table + 7 * LGBT_AP_ENTRIES;
  lgbt_gmap_launch(gmap, leaf_cap, table, Kd, cand, Kd, nullptr, 0, 1, st);
  wave_apply_kernel<T, true><<<grid, LGBT_THREADS, 0, st>>>(
      X, lor_in, table, cats, W, bundle, F, lor_out, slot_out, N, Kd,
      leaf_cap, gmap);
  lgbt_gmap_launch(gmap, leaf_cap, table, Kd, cand, Kd, nullptr, 0, 2, st);
}

extern "C" int lgbt_wave_apply(const void* X, int bin16, const void* lor_in,
                               const void* table, const void* cats, int W,
                               const void* bundle, int F, void* lor_out,
                               void* slot_out, long long N, int Kd,
                               int leaf_cap, void* gmap, int num_sms,
                               void* stream) {
  const long long quads = (N + LGBT_AP_ILP - 1) / LGBT_AP_ILP;
  const int grid = lgbt_grid(quads, num_sms, 4);
  cudaStream_t st = (cudaStream_t)stream;
  if (bin16)
    ap_launch((const uint16_t*)X, (const int*)lor_in, (const int*)table,
              (const int*)cats, W, (const int*)bundle, F, (int*)lor_out,
              (int*)slot_out, N, Kd, leaf_cap, (int*)gmap, grid, st);
  else
    ap_launch((const uint8_t*)X, (const int*)lor_in, (const int*)table,
              (const int*)cats, W, (const int*)bundle, F, (int*)lor_out,
              (int*)slot_out, N, Kd, leaf_cap, (int*)gmap, grid, st);
  return (int)cudaGetLastError();
}
