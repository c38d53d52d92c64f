// The general fused wave: membership from precomputed decision bits (a
// pending relabel first, then this wave's), the smaller-child slot
// histogram over any number of storage columns, then the best-split search
// of both children of every candidate.
//
// Replaces lightgbm_tpu/ops/grow_fused.py::wave_pass_fused_tiled_pallas
// (pallas_call at :656). The TPU kernel walks feature tiles of
// `fused_feature_tile` columns, because one tile's accumulator and parent
// slab must fit in VMEM, and merges the tiles' scan records by their raw
// gains (merge_tile_records). Here no tile is needed: the accumulation is
// the atomic scatter of hist_slots.cu over all F columns, and the scan
// (split_scan.cuh) runs one block per child over all F features, so there
// is nothing to merge. `fused_feature_tile` keeps only its meaning for the
// wave width (the K cap of ops/grow_wave.py:fused_kcap), which decides the
// trees.
//
// Decision bits, dec [Kd, N] uint8 per (entry k, row): bit 0 = goes left
// under this wave's applied entry k, bit 1 = lands in candidate k's
// smaller child, bit 2 = goes left under the pending (deferred) applied
// entry k of the previous applies-only wave. Each block builds three
// leaf -> entry maps in shared memory (pending, applied, candidate; 16-bit,
// 24 KB together), marking a leaf named by two active entries so that it
// matches neither (the TPU kernel's `inP == 1` / `inA == 1` rule), and a
// row reads at most three dec bytes. Design (c): like wave_pass_fused.cu,
// a histogram launch (+ the f64 -> f32 rounding) and then a scan launch.
//
// Quantized gradients: int8 value channels accumulate exactly in int32,
// and the scan subtracts parent - small in int32 before it descales
// (grow_fused.py:437-439; c * (a - b) is not c * a - c * b in f32).
//
// Bound: bytes. A row reads its leaf id, at most three dec bytes and, in a
// smaller child, its F bins and C values; it writes its new leaf id. The
// atomics of the smaller children's rows limit it as they limit
// hist_slots.cu; the parent histograms (K * 2 * F * B) are read once by
// the scan.
#include "split_scan.cuh"
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

template <typename V, bool SMEM>
__global__ void __launch_bounds__(LGBT_THREADS)
fused_tiled_hist_kernel(const uint8_t* __restrict__ X,
                        const V* __restrict__ vals,
                        const uint8_t* __restrict__ dec,
                        const int* __restrict__ lor_in,
                        const int* __restrict__ table,
                        const int* __restrict__ pend, int pend_nl0,
                        int* __restrict__ lor_out,
                        typename AccOf<V>::T* __restrict__ acc, long long N,
                        int F, int C, int K, int B, int Kd, int leaf_cap) {
  typedef typename AccOf<V>::T A;
  __shared__ unsigned short pend_of[LGBT_LEAF_CAP], app_of[LGBT_LEAF_CAP],
      cand_of[LGBT_LEAF_CAP];
  extern __shared__ __align__(8) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int hsize = K * C * F * B;
  if (SMEM)
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = (A)0;
  for (int i = threadIdx.x; i < leaf_cap; i += blockDim.x)
    pend_of[i] = app_of[i] = cand_of[i] = LGBT_MAP_NONE;
  __syncthreads();
  lgbt_map_entries16(pend, Kd, leaf_cap, pend_of);
  lgbt_map_entries16(table, Kd, leaf_cap, app_of);
  lgbt_map_entries16(table + 7 * LGBT_T_ENTRIES, K, leaf_cap, cand_of);
  __syncthreads();
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  A* dst = SMEM ? sh : acc;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    int leaf = lor_in[r];
    const int kp = lgbt_entry16(pend_of, leaf, leaf_cap);
    if (kp >= 0 && ((dec[(long long)kp * N + r] >> 2) & 1) == 0)
      leaf = pend_nl0 + kp;
    const int ka = lgbt_entry16(app_of, leaf, leaf_cap);
    if (ka >= 0 && (dec[(long long)ka * N + r] & 1) == 0) leaf = nl0 + ka;
    lor_out[r] = leaf;
    const int kc = lgbt_entry16(cand_of, leaf, leaf_cap);
    if (kc >= 0 && ((dec[(long long)kc * N + r] >> 1) & 1))
      add_row<V, A>(dst, X, vals, N, F, C, B, r, kc);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < hsize; i += blockDim.x)
      if (sh[i] != (A)0) atomicAdd(acc + i, sh[i]);
  }
}

template <typename V>
static void launch(const uint8_t* X, const V* vals, const uint8_t* dec,
                   const int* lor_in, const int* table, const int* pend,
                   int pend_nl0, int* lor_out, typename AccOf<V>::T* acc,
                   long long N, int F, int C, int K, int B, int Kd,
                   int leaf_cap, int num_sms, cudaStream_t stream) {
  const size_t hbytes = (size_t)K * C * F * B * sizeof(typename AccOf<V>::T);
  const size_t maps = 3 * LGBT_LEAF_CAP * sizeof(unsigned short);
  if (hbytes <= LGBT_SMEM_OPTIN_BYTES) {
    cudaFuncSetAttribute(fused_tiled_hist_kernel<V, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)hbytes);
    fused_tiled_hist_kernel<V, true>
        <<<lgbt_grid(N, num_sms, lgbt_smem_blocks_per_sm(hbytes + maps)),
           LGBT_THREADS, hbytes, stream>>>(X, vals, dec, lor_in, table, pend,
                                           pend_nl0, lor_out, acc, N, F, C, K,
                                           B, Kd, leaf_cap);
  } else {
    fused_tiled_hist_kernel<V, false>
        <<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, stream>>>(
            X, vals, dec, lor_in, table, pend, pend_nl0, lor_out, acc, N, F,
            C, K, B, Kd, leaf_cap);
  }
}

// X [F, N] uint8; vals [2, N] f32 (vals_int8 = 0) or int8; dec [Kd, N]
// uint8; lor_in / lor_out [N] int32; table [16, 128] int32 of which rows 0
// (applied leaves), 7 (candidate leaves) and 15 (nl0) are read, entries at
// Kd (applied) or K (candidates) and above inactive; pend [128] int32 the
// pending applied leaves (-1 = inactive; entries at Kd and above unread)
// and pend_nl0 their first new leaf id. f32 mode: acc [K * 2 * F * B] f64
// zeroed by the caller, out [K, 2, F, B] f32 written here, parent f32.
// int8 mode: out int32 zeroed by the caller is the accumulator, parent
// int32, descaled by gscale / hscale in the scan. scal / fmeta / fmask /
// rec as lgbt_split_scan_kernel.
extern "C" int lgbt_wave_pass_fused_tiled(
    const void* X, const void* vals, int vals_int8, const void* dec,
    const void* lor_in, const void* table, const void* pend, int pend_nl0,
    void* lor_out, void* out, void* acc, const void* parent, const void* scal,
    const void* fmeta, const void* fmask, int fmask_stride, void* rec,
    long long N, int F, int K, int B, int Kd, int leaf_cap, float gscale,
    float hscale, float min_data_slack, float min_hess, float l1, float l2,
    float max_delta_step, float path_smooth, float min_gain, int use_mds,
    int use_ps, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int C = 2;
  const LgbtSplitHp hp =
      lgbt_make_hp(min_data_slack, min_hess, l1, l2, max_delta_step,
                   path_smooth, min_gain, use_mds, use_ps);
  if (vals_int8) {
    launch<int8_t>((const uint8_t*)X, (const int8_t*)vals,
                   (const uint8_t*)dec, (const int*)lor_in,
                   (const int*)table, (const int*)pend, pend_nl0,
                   (int*)lor_out, (int*)out, N, F, C, K, B, Kd, leaf_cap,
                   num_sms, st);
    lgbt_split_scan_kernel<int><<<2 * K, LGBT_THREADS, 0, st>>>(
        (const int*)out, (const int*)parent, (const float*)scal,
        (const int*)fmeta, (const uint8_t*)fmask, fmask_stride, (float*)rec,
        K, F, B, gscale, hscale, hp);
  } else {
    launch<float>((const uint8_t*)X, (const float*)vals, (const uint8_t*)dec,
                  (const int*)lor_in, (const int*)table, (const int*)pend,
                  pend_nl0, (int*)lor_out, (double*)acc, N, F, C, K, B, Kd,
                  leaf_cap, num_sms, st);
    const long long n = (long long)K * C * F * B;
    acc_to_f32_kernel<<<lgbt_grid(n, num_sms, 4), LGBT_THREADS, 0, st>>>(
        (const double*)acc, (float*)out, n);
    lgbt_split_scan_kernel<float><<<2 * K, LGBT_THREADS, 0, st>>>(
        (const float*)out, (const float*)parent, (const float*)scal,
        (const int*)fmeta, (const uint8_t*)fmask, fmask_stride, (float*)rec,
        K, F, B, 1.0f, 1.0f, hp);
  }
  return (int)cudaGetLastError();
}
