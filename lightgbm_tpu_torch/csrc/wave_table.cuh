// The wave table shared by wave_pass.cu and wave_relabel.cu.
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
// instead of comparing against all 128.
#pragma once

#include "common.cuh"

#define LGBT_LEAF_CAP 4096
#define LGBT_T_ENTRIES 128

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

// Block prologue: packed entries and leaf -> entry maps in shared memory.
// Candidate entries past K are not mapped (the histogram width is K).
__device__ __forceinline__ void lgbt_load_table(
    const int* __restrict__ t, int K, int leaf_cap, bool with_cand,
    int* app_p, int* cand_p, signed char* app_of, signed char* cand_of) {
  for (int i = threadIdx.x; i < leaf_cap; i += blockDim.x) {
    app_of[i] = -1;
    if (with_cand) cand_of[i] = -1;
  }
  if (threadIdx.x < LGBT_T_ENTRIES) {
    const int k = threadIdx.x;
    app_p[k] = lgbt_pack_entry(t, 1, k, 0);
    if (with_cand)
      cand_p[k] = lgbt_pack_entry(t, 8, k, t[14 * LGBT_T_ENTRIES + k] & 1);
  }
  __syncthreads();
  if (threadIdx.x < LGBT_T_ENTRIES) {
    const int k = threadIdx.x;
    const int la = t[k];
    if (la >= 0 && la < leaf_cap) app_of[la] = (signed char)k;
    if (with_cand && k < K) {
      const int lc = t[7 * LGBT_T_ENTRIES + k];
      if (lc >= 0 && lc < leaf_cap) cand_of[lc] = (signed char)k;
    }
  }
  __syncthreads();
}

// The applied split of row r's leaf, if any: returns the new leaf id (the
// right child nl0 + entry for rows that go right, else unchanged).
__device__ __forceinline__ int lgbt_relabel(int lor, const int* app_p,
                                            const signed char* app_of,
                                            int leaf_cap, int nl0,
                                            const uint8_t* __restrict__ X,
                                            long long N, int F, long long r) {
  const int ka = (unsigned)lor < (unsigned)leaf_cap ? app_of[lor] : -1;
  if (ka >= 0 && !lgbt_go_left(app_p[ka], X, N, F, r)) return nl0 + ka;
  return lor;
}
