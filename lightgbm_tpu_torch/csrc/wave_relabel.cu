// Relabel only: apply the wave's splits to leaf_of_row (a tree's last
// wave, which has splits to apply and no candidates left).
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_relabel_pallas
// (pallas_call at :718), which runs the wave kernel's relabel half over
// [128, R] leaf-match masks. Here each row finds its applied entry through
// the shared-memory leaf -> entry map of wave_table.cuh.
//
// Bound: bytes (8 a row, plus a bin byte for each row whose leaf was
// split), but at 2^20 rows a call is a few microseconds and what sets its
// time is latency: a row's leaf id must arrive before its bin byte can be
// asked for, and the block's table (the leaf map's clear, six loads of
// each entry, the map's compare-and-swap, two barriers) before either can
// be used. Design (H100):
//   * one resident wave of LGBT_RELABEL_BLOCKS_PER_SM blocks of
//     LGBT_RELABEL_THREADS an SM, 2048 threads, so the table is decoded a
//     few hundred times a call and every SM has its full complement of
//     loads in flight;
//   * leaf ids move 16 bytes at a time, four rows a thread; a thread asks
//     for its first LGBT_RELABEL_UNROLL x 16 bytes of leaf ids (and the
//     table's nl0) before its block decodes the table, so those loads
//     overlap the decode; the four rows' bin bytes are asked for together;
//     a tail of N % 4 rows (or a misaligned array) goes a row at a time;
//   * the bin byte is read only for rows whose leaf was split;
//   * lor_out may be lor_in: each row is read, then written, by the same
//     thread, so the relabel runs in place.
#include "wave_table.cuh"

#ifndef LGBT_RELABEL_THREADS
#define LGBT_RELABEL_THREADS 512
#endif
#ifndef LGBT_RELABEL_BLOCKS_PER_SM
#define LGBT_RELABEL_BLOCKS_PER_SM 4
#endif
#ifndef LGBT_RELABEL_UNROLL
#define LGBT_RELABEL_UNROLL 1
#endif

// the new leaf ids of rows r .. r+3 of leaf ids v (lgbt_relabel, with the
// four bin loads issued before any is used)
template <class Map>
__device__ __forceinline__ int4 lgbt_relabel4(int4 v, const int* app_p,
                                              Map app_of, int nl0,
                                              const uint8_t* __restrict__ X,
                                              long long N, int F,
                                              long long r) {
  const int lor[4] = {v.x, v.y, v.z, v.w};
  int ka[4], p[4], col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ka[j] = app_of(lor[j]);
    p[j] = ka[j] >= 0 ? app_p[ka[j]] : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int feat = (int)((unsigned)p[j] & 31u);
    col[j] = (ka[j] >= 0 && feat < F) ? (int)X[(long long)feat * N + r + j]
                                      : 0;
  }
  int out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned u = (unsigned)p[j];
    const int thr = (int)((u >> 5) & 0xFFu);
    const bool dl = ((u >> 13) & 1u) != 0;
    const int mb = (int)((u >> 14) & 0x1FFu);
    const bool left = col[j] == mb ? dl : (col[j] <= thr);
    out[j] = (ka[j] >= 0 && !left) ? nl0 + ka[j] : lor[j];
  }
  return make_int4(out[0], out[1], out[2], out[3]);
}

// GM: the leaf map in global memory (gmap, L words; wave_table.cuh), else
// in the block's shared memory.
template <bool GM>
__global__ void __launch_bounds__(LGBT_RELABEL_THREADS,
                                  LGBT_RELABEL_BLOCKS_PER_SM)
wave_relabel_kernel(const uint8_t* __restrict__ X, const int* lor_in,
                    const int* __restrict__ table, int* lor_out, long long N,
                    int F, int leaf_cap, const int* __restrict__ gmap,
                    int vec) {
  __shared__ int app_p[LGBT_T_ENTRIES];
  __shared__ __align__(4) signed char app_of[GM ? 4 : LGBT_LEAF_CAP];
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec ? N >> 2 : 0;
  const int4* in4 = reinterpret_cast<const int4*>(lor_in);
  int4* out4 = reinterpret_cast<int4*>(lor_out);
  // the first leaf ids and nl0 in flight while the table is decoded
  int4 v[LGBT_RELABEL_UNROLL];
#pragma unroll
  for (int u = 0; u < LGBT_RELABEL_UNROLL; ++u) {
    const long long c = tid + u * nth;
    if (c < n4) v[u] = __ldcs(in4 + c);
  }
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  lgbt_load_table(table, 0, GM ? 0 : leaf_cap, false, app_p, nullptr, app_of,
                  nullptr);
  const LgbtMap<GM> amap = lgbt_map<GM>(app_of, gmap, leaf_cap);
  for (long long c0 = tid; c0 < n4; c0 += nth * LGBT_RELABEL_UNROLL) {
    if (c0 != tid) {
#pragma unroll
      for (int u = 0; u < LGBT_RELABEL_UNROLL; ++u) {
        const long long c = c0 + u * nth;
        if (c < n4) v[u] = __ldcs(in4 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < LGBT_RELABEL_UNROLL; ++u) {
      const long long c = c0 + u * nth;
      if (c < n4)
        __stcs(out4 + c,
               lgbt_relabel4(v[u], app_p, amap, nl0, X, N, F, c << 2));
    }
  }
  for (long long r = (n4 << 2) + tid; r < N; r += nth)
    lor_out[r] = lgbt_relabel(lor_in[r], app_p, amap, nl0, X, N, F, r);
}

// gmap: null for leaf_cap <= LGBT_LEAF_CAP (the shared leaf map), else the
// global maps' buffer, every word LGBT_GMAP_NONE, left so (wave_table.cuh).
extern "C" int lgbt_wave_relabel(const void* X, const void* lor_in,
                                 const void* table, void* lor_out, long long N,
                                 int F, int leaf_cap, void* gmap, int num_sms,
                                 void* stream) {
  // 16-byte accesses need both arrays 16-byte aligned
  const int vec = (((uintptr_t)lor_in | (uintptr_t)lor_out) & 15) == 0;
  const long long per_block = (long long)LGBT_RELABEL_THREADS *
                              (vec ? 4 * LGBT_RELABEL_UNROLL : 1);
  long long want = (N + per_block - 1) / per_block;
  const long long cap = (long long)num_sms * LGBT_RELABEL_BLOCKS_PER_SM;
  if (want < 1) want = 1;
  const int grid = (int)(want < cap ? want : cap);
  cudaStream_t st = (cudaStream_t)stream;
  const int* t = (const int*)table;
  if (!gmap) {
    wave_relabel_kernel<false><<<grid, LGBT_RELABEL_THREADS, 0, st>>>(
        (const uint8_t*)X, (const int*)lor_in, t, (int*)lor_out, N, F,
        leaf_cap, nullptr, vec);
    return (int)cudaGetLastError();
  }
  lgbt_gmap_launch((int*)gmap, leaf_cap, t, LGBT_T_ENTRIES, nullptr, 0,
                   nullptr, 0, 0, st);
  wave_relabel_kernel<true><<<grid, LGBT_RELABEL_THREADS, 0, st>>>(
      (const uint8_t*)X, (const int*)lor_in, t, (int*)lor_out, N, F,
      leaf_cap, (const int*)gmap, vec);
  lgbt_gmap_launch((int*)gmap, leaf_cap, t, LGBT_T_ENTRIES, nullptr, 0,
                   nullptr, 0, 2, st);
  return (int)cudaGetLastError();
}
