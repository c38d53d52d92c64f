// Stable partition of one leaf's window of the compact grower's row order:
// the rows order[start .. start + count) that go left under the leaf's
// split move to the front of the window, the rest behind them, each side in
// its order; the rows that go right take the new leaf's id in leaf_of_row;
// the left count is written to device memory.
//
// Replaces the partition of the JAX package's compact grower
// (lightgbm_tpu/ops/grow_fast.py:218, a stable cumsum scatter over the
// leaf's window padded to a power-of-two bucket, one `lax.switch` branch a
// bucket), which is XLA there, not a Pallas kernel. The port's batched
// compact step (ops/grow_batched.py:SerialStepper) calls it with the window
// and the split in device memory, so one captured graph serves every split
// of every tree, and the work follows the window, not N: the launch is
// planned for N rows, and the warps past the window's rows exit at once.
//
// The split record rec (int32, in device memory): start, count, storage
// column, threshold, default_left, missing bin (-1: none), is_cat, new
// leaf, W, then the W 32-bit words of the categorical bitset. A row's
// go-left is dec_go_left's (ops/grow_wave.py) on unbundled storage: a bin
// equal to the missing bin goes to default_left, else bin <= threshold; a
// categorical split tests bit `bin` of its bitset (bins are below 32 W).
//
// Four launches: the warps' left counts (each warp owns a contiguous chunk
// of ceil(count / W) positions, a multiple of 32), their exclusive scan in
// one block (the left count is its total), the scatter of the row ids into
// the scratch at their positions (a warp ranks its lanes with ballots), and
// the copy of the window back into order. Bound: bytes, each row's id, bin
// and leaf id read once a pass and its id written twice.
#include "hist_tiles.cuh"

#define LGBT_WP_HEAD 9         // the record's fields before the bitset

template <typename T>
__device__ __forceinline__ bool wp_go_left(const T* __restrict__ X,
                                           long long N, const int* rec,
                                           int col, int thr, int dl, int mb,
                                           int is_cat, int W, int r) {
  const int b = X[(long long)col * N + r];
  if (is_cat) {
    const unsigned w =
        (unsigned)__ldg(rec + LGBT_WP_HEAD + min(b >> 5, W - 1));
    return (w >> (b & 31)) & 1u;
  }
  return b == mb ? dl != 0 : b <= thr;
}

// warp w's positions [lo, hi) of a window of `count` rows split among W
// warps
__device__ __forceinline__ void wp_chunk(int count, int W, int w, int* lo,
                                         int* hi) {
  int chunk = (count + W - 1) / W;
  chunk = (chunk + 31) / 32 * 32;
  const long long a = (long long)w * chunk;
  *lo = a < count ? (int)a : count;
  *hi = a + chunk < count ? (int)(a + chunk) : count;
}

// SCATTER = false: wl[w] = the left rows of warp w's chunk. SCATTER = true:
// the chunk's row ids into tmp (lefts from wl[w], rights from
// nl + lo - wl[w], wl scanned), and the new leaf id of the right rows.
template <typename T, bool SCATTER>
__global__ void __launch_bounds__(LGBT_THREADS)
wp_pass_kernel(const T* __restrict__ X, const int* __restrict__ order,
               const int* __restrict__ rec, long long N, int F, int W,
               int* __restrict__ wl, const int* __restrict__ nl,
               int* __restrict__ tmp, int* __restrict__ lor) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (LGBT_THREADS / 32) + (threadIdx.x >> 5);
  if (w >= W) return;                                 // warp-uniform
  const int start = rec[0], count = rec[1];
  const int col = min(max(rec[2], 0), F - 1), thr = rec[3], dl = rec[4];
  const int mb = rec[5], is_cat = rec[6], leaf = rec[7];
  const int nw = rec[8];                              // the bitset words
  int lo, hi;
  wp_chunk(count, W, w, &lo, &hi);
  int nleft = 0, left = 0, right = 0;
  if (SCATTER) {
    left = wl[w];
    right = *nl + lo - left;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const bool ok = i < hi;
    const int r = ok ? order[start + i] : 0;
    const bool gl = ok && wp_go_left(X, N, rec, col, thr, dl, mb, is_cat, nw,
                                     r);
    const unsigned bl = __ballot_sync(0xffffffffu, gl);
    if (!SCATTER) {
      nleft += __popc(bl);
      continue;
    }
    const unsigned br = __ballot_sync(0xffffffffu, ok && !gl);
    if (ok) {
      const int dest = gl ? left + __popc(bl & below)
                          : right + __popc(br & below);
      tmp[start + dest] = r;
      if (!gl) lor[r] = leaf;
    }
    left += __popc(bl);
    right += __popc(br);
  }
  if (!SCATTER && lane == 0) wl[w] = nleft;
}

// order[start + i] = tmp[start + i] for i < count
__global__ void __launch_bounds__(LGBT_THREADS)
wp_copy_kernel(const int* __restrict__ rec, const int* __restrict__ tmp,
               int* __restrict__ order) {
  const int start = rec[0], count = rec[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x)
    order[start + i] = tmp[start + i];
}

// X [F, N] uint8 (bin16 = 0) or uint16, order / lor / tmp [N] int32, rec
// int32 [LGBT_WP_HEAD + W] the record above, wl [W] int32 scratch with
// 1 <= W <= 1024 warps, n_left [1] int32 out.
extern "C" int lgbt_window_partition(const void* X, int bin16,
                                     void* order, void* lor, const void* rec,
                                     void* wl, void* tmp, void* n_left,
                                     long long N, int F, int W, int num_sms,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* r = (const int*)rec;
  const int blocks = (W + LGBT_THREADS / 32 - 1) / (LGBT_THREADS / 32);
  int* o = (int*)order;
  int* w = (int*)wl;
  int* nl = (int*)n_left;
  if (bin16) {
    wp_pass_kernel<uint16_t, false><<<blocks, LGBT_THREADS, 0, st>>>(
        (const uint16_t*)X, o, r, N, F, W, w, nl, (int*)tmp, (int*)lor);
  } else {
    wp_pass_kernel<uint8_t, false><<<blocks, LGBT_THREADS, 0, st>>>(
        (const uint8_t*)X, o, r, N, F, W, w, nl, (int*)tmp, (int*)lor);
  }
  group_scan_kernel<<<1, 1024, 0, st>>>(w, W, nl);
  if (bin16) {
    wp_pass_kernel<uint16_t, true><<<blocks, LGBT_THREADS, 0, st>>>(
        (const uint16_t*)X, o, r, N, F, W, w, nl, (int*)tmp, (int*)lor);
  } else {
    wp_pass_kernel<uint8_t, true><<<blocks, LGBT_THREADS, 0, st>>>(
        (const uint8_t*)X, o, r, N, F, W, w, nl, (int*)tmp, (int*)lor);
  }
  wp_copy_kernel<<<lgbt_grid(N, num_sms, 4), LGBT_THREADS, 0, st>>>(
      r, (const int*)tmp, o);
  return (int)cudaGetLastError();
}
