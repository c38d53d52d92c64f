// The numeric best-split search of the fused wave kernels: for every child
// of a wave's candidates, what lightgbm_tpu_torch/ops/split.py:
// find_best_split computes on synth_count_channel of the child's
// histogram, field for field, with the monotone operand: each cell's child
// outputs clipped into the child's bounds (scalar rows 5 / 6, +-inf when
// unconstrained: a bitwise no-op), and a cell of a feature whose direction
// (meta row 4) is +1 rejected when its clipped left output exceeds the
// right one, -1 when it falls below (_fused_scan_tiled's monotone rows,
// lightgbm_tpu/ops/grow_fused.py:402-449).
//
// Replaces the in-kernel scan of lightgbm_tpu/ops/grow_fused.py
// (_fused_scan :202, _fused_scan_tiled :402), which traces the JAX search
// on the VMEM-resident histogram on the TPU grid's last step.
//
// Layout: a warp per (child, feature). Block (x, j) holds child j of [0,
// 2K) (left children first, as the record columns) and features
// [8x, 8x + 8), a warp each. A warp
//   1. stages the feature's child values (small, or parent - small; the
//      count channel synthesized) in shared memory, 32 lanes a row of bins;
//   2. forms the prefix sums: lane c walks channel c's bins in order,
//      adding in f64, and writes each prefix back rounded once to f32. That
//      is what the port's plain search does (torch.cumsum over the f64
//      histogram, rounded), and f64 sums of f32 values are not associative,
//      so only this order keeps the records bitwise equal to it on
//      continuous values. Bins past num_bins add zeros, so the walk stops
//      there and the channel total is the last prefix;
//   3. computes the cells of both scan directions, each lane at bins lane,
//      lane + 32, ..., with __fadd_rn / __fmul_rn / __fdiv_rn (nvcc fuses
//      nothing into an FMA, and each step rounds as one torch operation
//      does), and reduces the warp's best cell.
// The argmax is the first maximum in (direction, feature, bin) order: each
// cell's key is (gain, flat index) packed so that a larger key means a
// larger gain, then a smaller index (gain -0.0 read as +0.0), and the
// block's and then the child's best key is an atomicMax, whatever order
// the warps finish in. A child with no valid cell takes index 0 with gain
// -inf, as the plain argmax over an all -inf map. The lane holding its
// warp's best cell keeps that cell's statistics (lgbt_cell on the
// in-order prefix sums) and writes them to scratch; the last block of a
// child (a completion counter) copies the winner's into the child's
// record, so no serial recomputation of a feature's prefix waits at the
// end; only a child without a valid split recomputes its index-0 cell.
//
// The smaller child's histogram comes as f32 (a tile flush rounded it), as
// int32 (int8 values: parent - small subtracts exactly, then descales), or
// as the f64 accumulators of a direct sweep; then the warps of the left
// children also write its f32 rounding, the histogram the grower keeps, so
// no rounding launch runs.
//
// Bound: operations, and few of them (2 F B cells of about 60 f32
// operations per child). The serial part of a warp is the f64 prefix, B
// dependent adds; every (child, feature) is a warp in flight (2K * F of
// them), not one thread of 2K blocks walking B cells twice. The histogram
// it reads stays in L2 from the accumulation launch before it.
#pragma once

#include <math.h>

#include "common.cuh"

#define LGBT_REC_FIELDS 12   // SplitResult fields, in field order
#define LGBT_MISSING_ZERO 1
#define LGBT_MISSING_NAN 2
#define LGBT_SCAN_WARPS 8    // features per scan block, a warp each
#define LGBT_SCAN_MAX_B 256

struct LgbtSplitHp {
  float min_data_slack;  // min_data_in_leaf - 0.5, on the unrounded count
  float min_hess;        // min_sum_hessian_in_leaf
  float l1, l2;
  float max_delta_step;  // read when use_mds
  float path_smooth;     // read when use_ps
  float min_gain;        // min_gain_to_split
  int use_mds, use_ps;
};

__device__ __forceinline__ float lgbt_sign(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

// torch.clamp(x, min=0): NaN passes through
__device__ __forceinline__ float lgbt_clamp0(float x) {
  return x < 0.f ? 0.f : x;
}

__device__ __forceinline__ float lgbt_threshold_l1(float s, float l1) {
  return __fmul_rn(lgbt_sign(s), lgbt_clamp0(__fsub_rn(fabsf(s), l1)));
}

// split.py:leaf_output (CalculateSplittedLeafOutput)
__device__ __forceinline__ float lgbt_leaf_output(float sg, float sh,
                                                  float num, float pout,
                                                  const LgbtSplitHp& hp) {
  float r = __fdiv_rn(-lgbt_threshold_l1(sg, hp.l1), __fadd_rn(sh, hp.l2));
  if (hp.use_mds && !isnan(r))
    r = fminf(fmaxf(r, -hp.max_delta_step), hp.max_delta_step);
  if (hp.use_ps) {
    const float nos = __fdiv_rn(num, hp.path_smooth);
    const float den = __fadd_rn(nos, 1.0f);
    r = __fadd_rn(__fdiv_rn(__fmul_rn(r, nos), den), __fdiv_rn(pout, den));
  }
  return r;
}

// split.py:leaf_gain_given_output
__device__ __forceinline__ float lgbt_gain_given_output(float sg, float sh,
                                                        float out,
                                                        const LgbtSplitHp& hp) {
  const float a = __fmul_rn(__fmul_rn(2.0f, lgbt_threshold_l1(sg, hp.l1)),
                            out);
  const float b = __fmul_rn(__fmul_rn(__fadd_rn(sh, hp.l2), out), out);
  return -__fadd_rn(a, b);
}

// one child's value of channel c at a bin: the smaller child's histogram,
// or parent minus it (f32); the f64 accumulators of a direct sweep read as
// their f32 rounding; int32 histograms subtract exactly and are descaled
// after (grow_fused.py:437-439)
__device__ __forceinline__ float lgbt_child_value(float s, float p,
                                                  bool use_small, float) {
  return use_small ? s : __fsub_rn(p, s);
}
__device__ __forceinline__ float lgbt_child_value(double s, float p,
                                                  bool use_small, float) {
  const float sf = (float)s;
  return use_small ? sf : __fsub_rn(p, sf);
}
__device__ __forceinline__ float lgbt_child_value(int s, int p,
                                                  bool use_small,
                                                  float scale) {
  return __fmul_rn((float)(use_small ? s : p - s), scale);
}

struct LgbtCell {
  float lg, lh, lc, rg, rh, rc, lout, rout, gain;
  bool ok;
};

// torch.clamp(x, lo, hi) on the card, bit for bit: NaN passes through,
// then fmaxf / fminf (no arithmetic, so nothing to contract)
__device__ __forceinline__ float lgbt_clip(float x, float lo, float hi) {
  if (isnan(x)) return x;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(x, lo), hi);
}

// split.py:_numeric_gain_map at one (direction, threshold) cell from the
// f32 prefixes (cg, chh, cc) and the missing mass (mg, mh, mc); the
// outputs clipped into [bmin, bmax], the direction `mono` enforced on them
__device__ __forceinline__ LgbtCell lgbt_cell(float cg, float chh, float cc,
                                              float mg, float mh, float mc,
                                              int d, float pg, float ph,
                                              float pc, float pout,
                                              float bmin, float bmax,
                                              int mono,
                                              const LgbtSplitHp& hp) {
  LgbtCell o;
  const float lcu = d ? __fadd_rn(cc, mc) : cc;
  o.lg = d ? __fadd_rn(cg, mg) : cg;
  o.lh = d ? __fadd_rn(chh, mh) : chh;
  o.rg = __fsub_rn(pg, o.lg);
  o.rh = __fsub_rn(ph, o.lh);
  const float rcu = __fsub_rn(pc, lcu);
  o.lc = rintf(lcu);
  o.rc = rintf(rcu);
  o.ok = lcu >= hp.min_data_slack && rcu >= hp.min_data_slack &&
         o.lh >= hp.min_hess && o.rh >= hp.min_hess;
  o.lout = lgbt_clip(lgbt_leaf_output(o.lg, o.lh, o.lc, pout, hp), bmin,
                     bmax);
  o.rout = lgbt_clip(lgbt_leaf_output(o.rg, o.rh, o.rc, pout, hp), bmin,
                     bmax);
  if ((mono > 0 && o.lout > o.rout) || (mono < 0 && o.lout < o.rout))
    o.ok = false;
  o.gain = __fadd_rn(lgbt_gain_given_output(o.lg, o.lh, o.lout, hp),
                     lgbt_gain_given_output(o.rg, o.rh, o.rout, hp));
  return o;
}

__device__ __forceinline__ float lgbt_finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

// The per-child constants of the scan.
struct LgbtChild {
  int k;                   // candidate
  bool use_small;          // this child is the smaller one
  float sg, sh, cnt, pout;
  float cntf;              // synth_count_channel's count / sum_h
  float mgs;               // min_gain_shift
  float bmin, bmax;        // the monotone bounds of the child's outputs
};

__device__ __forceinline__ LgbtChild lgbt_child(const float* __restrict__ scal,
                                                int j, int K,
                                                const LgbtSplitHp& hp) {
  const int n2 = 2 * K;
  LgbtChild ch;
  const bool is_left = j < K;
  ch.k = is_left ? j : j - K;
  ch.sg = scal[j];
  ch.sh = scal[n2 + j];
  ch.cnt = scal[2 * n2 + j];
  ch.pout = scal[3 * n2 + j];
  ch.use_small = is_left == (scal[4 * n2 + j] != 0.f);
  ch.bmin = scal[5 * n2 + j];
  ch.bmax = scal[6 * n2 + j];
  // synth_count_channel: count / clamp(sum_h, min=1e-12), NaN kept
  ch.cntf = __fdiv_rn(ch.cnt, ch.sh < 1e-12f ? 1e-12f : ch.sh);
  ch.mgs = __fadd_rn(
      lgbt_gain_given_output(
          ch.sg, ch.sh, lgbt_leaf_output(ch.sg, ch.sh, ch.cnt, ch.pout, hp),
          hp),
      hp.min_gain);
  return ch;
}

// the excluded bin of a feature (split.py's `excl`): the missing bin
__device__ __forceinline__ int lgbt_missing_bin(int nb, int mt, int db) {
  return mt == LGBT_MISSING_NAN ? nb - 1 : (mt == LGBT_MISSING_ZERO ? db : -1);
}

// Feature f's prefix sums for one child, by one warp: a[c][b] becomes the
// f32 rounding of the f64 sum of channel c over bins [0, b] for b < top =
// min(nb, B), tot[c] that of the whole feature (the missing and the
// out-of-range bins read as 0). Ends synchronised over the warp.
template <typename S, typename P>
__device__ __forceinline__ int lgbt_feature_prefix(
    float (*a)[LGBT_SCAN_MAX_B], float* tot, const S* __restrict__ sm,
    const P* __restrict__ pa, long long plane, int f, int B, int nb,
    int mbin, const LgbtChild& ch, float gscale, float hscale, int lane) {
  const int top = min(nb, B);
  for (int b = lane; b < top; b += 32) {
    float g = 0.f, h = 0.f, c = 0.f;
    if (b != mbin) {
      const long long i = (long long)f * B + b;
      g = lgbt_child_value(sm[i], pa[i], ch.use_small, gscale);
      h = lgbt_child_value(sm[plane + i], pa[plane + i], ch.use_small,
                           hscale);
      c = __fmul_rn(h, ch.cntf);
    }
    a[0][b] = g;
    a[1][b] = h;
    a[2][b] = c;
  }
  __syncwarp();
  if (lane < 3) {
    // bins in order, one lane a channel: the plain search's f64 cumsum;
    // eight bins' loads issued together, then their adds in order
    float* x = a[lane];
    double s = 0.0;
    int b = 0;
    for (; b + 8 <= top; b += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = x[b + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s += (double)v[q];
        x[b + q] = (float)s;
      }
    }
    for (; b < top; ++b) {
      s += (double)x[b];
      x[b] = (float)s;
    }
    tot[lane] = (float)s;
  }
  __syncwarp();
  return top;
}

// the cell of (direction d, bin b) from the staged prefix sums, on a
// feature of monotone direction `mono`
__device__ __forceinline__ LgbtCell lgbt_cell_at(
    float (*a)[LGBT_SCAN_MAX_B], const float* tot, int top, int b,
    int d, int mono, const LgbtChild& ch, const LgbtSplitHp& hp) {
  const bool in = b < top;               // past num_bins: the total
  return lgbt_cell(in ? a[0][b] : tot[0], in ? a[1][b] : tot[1],
                   in ? a[2][b] : tot[2], __fsub_rn(ch.sg, tot[0]),
                   __fsub_rn(ch.sh, tot[1]), __fsub_rn(ch.cnt, tot[2]), d,
                   ch.sg, ch.sh, ch.cnt, ch.pout, ch.bmin, ch.bmax, mono,
                   hp);
}

// (gain, flat index) as one key: larger gain first, then smaller index
__device__ __forceinline__ unsigned long long lgbt_key(float g, int idx) {
  unsigned u = __float_as_uint(g == 0.f ? 0.f : g);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)idx);
}

__device__ __forceinline__ float lgbt_key_gain(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int lgbt_key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)key);
}

// the record fields of a child's winning cell
__device__ __forceinline__ void lgbt_write_record(float* rec, int n2, int j,
                                                  float gain, float mgs,
                                                  int f, int b, int d,
                                                  const float* st) {
  const float vals[LGBT_REC_FIELDS] = {
      isfinite(gain) ? __fsub_rn(gain, mgs) : -INFINITY,
      (float)f, (float)b, (float)d,
      lgbt_finite_or_zero(st[0]), lgbt_finite_or_zero(st[1]),
      lgbt_finite_or_zero(st[2]), lgbt_finite_or_zero(st[3]),
      lgbt_finite_or_zero(st[4]), lgbt_finite_or_zero(st[5]),
      lgbt_finite_or_zero(st[6]), lgbt_finite_or_zero(st[7])};
#pragma unroll
  for (int r = 0; r < LGBT_REC_FIELDS; ++r) rec[r * n2 + j] = vals[r];
}

// small: [K, 2, F, B] f32 or f64 (parent f32), or int32 (parent int32,
// descaled by scale[0] / scale[1], a [2] f32 device operand; null for
// f32 sums); parent [K, 2, F, B]; small_out: with f64
// small, its [K, 2, F, B] f32 rounding written here, else null; scal
// [7, 2K] f32 rows sum_g, sum_h, count, output, smaller_is_left (0 / 1),
// bounds min, bounds max per child; fmeta [5, F] int32 rows num_bins,
// missing_type, default_bin, is_categorical, monotone direction; fmask
// [F] (fmask_stride 0) or [2K, F] (fmask_stride F) uint8; rec [12, 2K]
// f32 out, the SplitResult fields with feature / threshold /
// default_left as exact small floats; best [2K] u64 and done
// [2K] u32 zeroed by the caller; cells [2K, F, 8] f32 scratch, each
// (child, feature) warp's best cell's statistics, which the child's last
// block copies for the winner (recomputing the cell only where no split
// is valid). Grid (ceil(F / 8), 2K), LGBT_THREADS.
template <typename S, typename P>
__global__ void __launch_bounds__(LGBT_THREADS)
lgbt_split_scan_kernel(const S* __restrict__ small,
                       const P* __restrict__ parent,
                       float* __restrict__ small_out,
                       const float* __restrict__ scal,
                       const int* __restrict__ fmeta,
                       const uint8_t* __restrict__ fmask, int fmask_stride,
                       float* __restrict__ rec,
                       unsigned long long* __restrict__ best,
                       unsigned* __restrict__ done, float* __restrict__ cells,
                       int K, int F, int B,
                       const float* __restrict__ scale, LgbtSplitHp hp) {
  __shared__ float stage[LGBT_SCAN_WARPS][3][LGBT_SCAN_MAX_B];
  __shared__ float tots[LGBT_SCAN_WARPS][3];
  __shared__ unsigned long long blk_best;
  __shared__ int last;
  const int n2 = 2 * K, j = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const LgbtChild ch = lgbt_child(scal, j, K, hp);
  // the int32 histograms' descale factors, read from device memory so that
  // a captured graph replays each tree's own (null: f32 sums, unscaled)
  const float gscale = scale ? scale[0] : 1.0f;
  const float hscale = scale ? scale[1] : 1.0f;
  const long long plane = (long long)F * B;
  const S* sm = small + (long long)ch.k * 2 * plane;
  const P* pa = parent + (long long)ch.k * 2 * plane;
  // no valid cell: index 0 with gain -inf
  const unsigned long long floor_key = lgbt_key(-INFINITY, 0);
  if (threadIdx.x == 0) blk_best = floor_key;
  __syncthreads();
  const int f = blockIdx.x * LGBT_SCAN_WARPS + w;
  if (f < F) {
    if (small_out && j < K) {
      float* so = small_out + (long long)ch.k * 2 * plane;
      for (int b = lane; b < B; b += 32) {
        const long long i = (long long)f * B + b;
        so[i] = (float)sm[i];
        so[plane + i] = (float)sm[plane + i];
      }
    }
    const int nb = fmeta[f], mt = fmeta[F + f], db = fmeta[2 * F + f];
    const int mono = fmeta[4 * F + f];
    const bool allowed =
        fmask[(long long)j * fmask_stride + f] != 0 && fmeta[3 * F + f] == 0;
    if (allowed) {                       // else every cell is -inf
      const int top = lgbt_feature_prefix(stage[w], tots[w], sm, pa, plane,
                                          f, B, nb,
                                          lgbt_missing_bin(nb, mt, db), ch,
                                          gscale, hscale, lane);
      const int max_t = nb - 2;
      const int max_t_r = mt == LGBT_MISSING_NAN ? nb - 3 : max_t;
      unsigned long long mine = floor_key;
      float st[8];
      for (int b = lane; b <= max_t && b < B; b += 32) {
        if (mt == LGBT_MISSING_ZERO && b == db) continue;
        for (int d = 0; d < 2; ++d) {
          if (b > (d ? max_t_r : max_t)) continue;
          const LgbtCell o = lgbt_cell_at(stage[w], tots[w], top, b, d,
                                          mono, ch, hp);
          if (o.ok && o.gain > ch.mgs) {
            const unsigned long long key =
                lgbt_key(o.gain, (d * F + f) * B + b);
            if (key > mine) {
              mine = key;
              st[0] = o.lg; st[1] = o.lh; st[2] = o.lc; st[3] = o.rg;
              st[4] = o.rh; st[5] = o.rc; st[6] = o.lout; st[7] = o.rout;
            }
          }
        }
      }
      unsigned long long wbest = mine;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = __shfl_xor_sync(0xffffffffu, wbest, o);
        if (x > wbest) wbest = x;
      }
      if (wbest > floor_key && mine == wbest) {   // one lane: the index
        float* c = cells + ((long long)j * F + f) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) c[q] = st[q];
        __threadfence();
        atomicMax(&blk_best, wbest);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (blk_best > floor_key) atomicMax(best + j, blk_best);
    __threadfence();
    last = atomicAdd(done + j, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || w != 0) return;
  // the child's last block: its first warp writes the record
  __threadfence();
  const unsigned long long key = __ldcg(best + j);
  if (key > floor_key) {
    const int bi = lgbt_key_index(key);
    const int bf = (bi / B) % F;
    if (lane == 0) {
      float st[8];
      const float* c = cells + ((long long)j * F + bf) * 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) st[q] = __ldcg(c + q);
      lgbt_write_record(rec, n2, j, lgbt_key_gain(key), ch.mgs, bf, bi % B,
                        bi / (F * B), st);
    }
    return;
  }
  // no valid split: the cell at index 0, as the plain argmax picks it
  const int nb = fmeta[0], mt = fmeta[F], db = fmeta[2 * F];
  const int top = lgbt_feature_prefix(stage[0], tots[0], sm, pa, plane, 0,
                                      B, nb, lgbt_missing_bin(nb, mt, db),
                                      ch, gscale, hscale, lane);
  if (lane != 0) return;
  const LgbtCell o =
      lgbt_cell_at(stage[0], tots[0], top, 0, 0, fmeta[4 * F], ch, hp);
  const float st[8] = {o.lg, o.lh, o.lc, o.rg, o.rh, o.rc, o.lout, o.rout};
  lgbt_write_record(rec, n2, j, -INFINITY, ch.mgs, 0, 0, 0, st);
}

static inline LgbtSplitHp lgbt_make_hp(float min_data_slack, float min_hess,
                                       float l1, float l2,
                                       float max_delta_step,
                                       float path_smooth, float min_gain,
                                       int use_mds, int use_ps) {
  LgbtSplitHp hp;
  hp.min_data_slack = min_data_slack;
  hp.min_hess = min_hess;
  hp.l1 = l1;
  hp.l2 = l2;
  hp.max_delta_step = max_delta_step;
  hp.path_smooth = path_smooth;
  hp.min_gain = min_gain;
  hp.use_mds = use_mds;
  hp.use_ps = use_ps;
  return hp;
}

// Zero the scan's keys and counters and launch the scan over the 2K
// children of a wave; scratch is [2K] u64 best keys, [2K] u32 completion
// counters, then the [2K, F, 8] f32 cells.
template <typename S, typename P>
static void lgbt_split_scan_launch(const S* small, const P* parent,
                                   float* small_out, const float* scal,
                                   const int* fmeta, const uint8_t* fmask,
                                   int fmask_stride, float* rec,
                                   void* scratch, int K, int F, int B,
                                   const float* scale,
                                   const LgbtSplitHp& hp, cudaStream_t st) {
  unsigned long long* best = (unsigned long long*)scratch;
  unsigned* done = (unsigned*)(best + 2 * K);
  float* cells = (float*)(done + 2 * K);
  cudaMemsetAsync(scratch, 0, (size_t)2 * K * (8 + 4), st);
  const dim3 grid((F + LGBT_SCAN_WARPS - 1) / LGBT_SCAN_WARPS, 2 * K);
  lgbt_split_scan_kernel<S, P><<<grid, LGBT_THREADS, 0, st>>>(
      small, parent, small_out, scal, fmeta, fmask, fmask_stride, rec, best,
      done, cells, K, F, B, scale, hp);
}
