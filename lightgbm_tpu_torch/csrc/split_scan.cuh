// The numeric best-split search of the fused wave kernels: for every child
// of a wave's candidates, what lightgbm_tpu_torch/ops/split.py:
// find_best_split computes on synth_count_channel of the child's
// histogram, field for field.
//
// Replaces the in-kernel scan of lightgbm_tpu/ops/grow_fused.py
// (_fused_scan :202, _fused_scan_tiled :402), which traces the JAX search
// on the VMEM-resident histogram on the TPU grid's last step.
//
// Layout: one block per child j of [0, 2K) (left children first, as the
// record columns), one thread per feature (a stride loop past the block
// width). A thread walks its feature's bins in order twice: once for the
// channel totals, once for the prefixes and the gains of both scan
// directions at each threshold. Both walks add in f64 and round each prefix
// once to f32, which is what the port's plain search does (torch.cumsum
// over the f64 histogram, rounded), so the two agree bit for bit. The gain
// and output arithmetic uses __fadd_rn / __fmul_rn / __fdiv_rn: nvcc fuses
// nothing into an FMA, and each step rounds as one torch operation does.
// The argmax is the first maximum in (direction, feature, bin) order: a
// block reduction on (gain descending, flat index ascending). The winner's
// statistics are recomputed by one thread from the same in-order sums.
//
// Bound: operations, and few of them (2 F B cells of about 60 f32
// operations per child). The histogram it reads stays in L2 from the
// accumulation launch before it.
#pragma once

#include <math.h>

#include "common.cuh"

#define LGBT_REC_FIELDS 12   // SplitResult fields, in field order
#define LGBT_MISSING_ZERO 1
#define LGBT_MISSING_NAN 2

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
// or parent minus it (f32); int32 histograms subtract exactly and are
// descaled after (grow_fused.py:437-439)
__device__ __forceinline__ float lgbt_child_value(float s, float p,
                                                  bool use_small, float) {
  return use_small ? s : __fsub_rn(p, s);
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

// split.py:_numeric_gain_map at one (direction, threshold) cell from the
// f32 prefixes (cg, chh, cc) and the missing mass (mg, mh, mc)
__device__ __forceinline__ LgbtCell lgbt_cell(float cg, float chh, float cc,
                                              float mg, float mh, float mc,
                                              int d, float pg, float ph,
                                              float pc, float pout,
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
  o.lout = lgbt_leaf_output(o.lg, o.lh, o.lc, pout, hp);
  o.rout = lgbt_leaf_output(o.rg, o.rh, o.rc, pout, hp);
  o.gain = __fadd_rn(lgbt_gain_given_output(o.lg, o.lh, o.lout, hp),
                     lgbt_gain_given_output(o.rg, o.rh, o.rout, hp));
  return o;
}

__device__ __forceinline__ float lgbt_finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

// small / parent: [K, 2, F, B] (f32, or int32 with the descale factors
// gscale / hscale); scal [5, 2K] f32 rows sum_g, sum_h, count, output,
// smaller_is_left (0 / 1) per child; fmeta [4, F] int32 rows num_bins,
// missing_type, default_bin, is_categorical; fmask [F] (fmask_stride 0) or
// [2K, F] (fmask_stride F) uint8; rec [12, 2K] f32 out, the SplitResult
// fields with feature / threshold / default_left as exact small floats.
template <typename H>
__global__ void __launch_bounds__(LGBT_THREADS)
lgbt_split_scan_kernel(const H* __restrict__ small,
                       const H* __restrict__ parent,
                       const float* __restrict__ scal,
                       const int* __restrict__ fmeta,
                       const uint8_t* __restrict__ fmask, int fmask_stride,
                       float* __restrict__ rec, int K, int F, int B,
                       float gscale, float hscale, LgbtSplitHp hp) {
  __shared__ float red_g[LGBT_THREADS];
  __shared__ int red_i[LGBT_THREADS];
  const int n2 = 2 * K;
  const int j = blockIdx.x;
  const bool is_left = j < K;
  const int k = is_left ? j : j - K;
  const float sg = scal[j], sh = scal[n2 + j], cnt = scal[2 * n2 + j];
  const float pout = scal[3 * n2 + j];
  const bool use_small = is_left == (scal[4 * n2 + j] != 0.f);
  // synth_count_channel: count / clamp(sum_h, min=1e-12), NaN kept
  const float cntf = __fdiv_rn(cnt, sh < 1e-12f ? 1e-12f : sh);
  const float mgs = __fadd_rn(
      lgbt_gain_given_output(sg, sh,
                             lgbt_leaf_output(sg, sh, cnt, pout, hp), hp),
      hp.min_gain);
  const long long plane = (long long)F * B;
  const H* sm = small + (long long)k * 2 * plane;
  const H* pa = parent + (long long)k * 2 * plane;

  // channel totals of feature f over bins [0, upto], the missing and the
  // out-of-range bins read as 0 (split.py's `excl`)
  auto sums = [&](int f, int upto, int mbin, int nb, double* out3) {
    double tg = 0.0, th = 0.0, tc = 0.0;
    for (int b = 0; b <= upto; ++b) {
      float g = 0.f, h = 0.f, c = 0.f;
      if (b != mbin && b < nb) {
        const long long i = (long long)f * B + b;
        g = lgbt_child_value(sm[i], pa[i], use_small, gscale);
        h = lgbt_child_value(sm[plane + i], pa[plane + i], use_small,
                             hscale);
        c = __fmul_rn(h, cntf);
      }
      tg += (double)g;
      th += (double)h;
      tc += (double)c;
    }
    out3[0] = tg;
    out3[1] = th;
    out3[2] = tc;
  };

  float best_g = -INFINITY;
  int best_i = 0x7FFFFFFF;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int nb = fmeta[f], mt = fmeta[F + f], db = fmeta[2 * F + f];
    const bool allowed =
        fmask[(long long)j * fmask_stride + f] != 0 && fmeta[3 * F + f] == 0;
    const int mbin = mt == LGBT_MISSING_NAN
                         ? nb - 1
                         : (mt == LGBT_MISSING_ZERO ? db : -1);
    double tot[3];
    sums(f, B - 1, mbin, nb, tot);
    const float mg = __fsub_rn(sg, (float)tot[0]);
    const float mh = __fsub_rn(sh, (float)tot[1]);
    const float mc = __fsub_rn(cnt, (float)tot[2]);
    const int max_t = nb - 2;
    const int max_t_r = mt == LGBT_MISSING_NAN ? nb - 3 : max_t;
    double pg = 0.0, ph = 0.0, pc = 0.0;
    for (int b = 0; b < B; ++b) {
      float g = 0.f, h = 0.f, c = 0.f;
      if (b != mbin && b < nb) {
        const long long i = (long long)f * B + b;
        g = lgbt_child_value(sm[i], pa[i], use_small, gscale);
        h = lgbt_child_value(sm[plane + i], pa[plane + i], use_small,
                             hscale);
        c = __fmul_rn(h, cntf);
      }
      pg += (double)g;
      ph += (double)h;
      pc += (double)c;
      const bool skip_default = mt == LGBT_MISSING_ZERO && b == db;
      for (int d = 0; d < 2; ++d) {
        const LgbtCell o = lgbt_cell((float)pg, (float)ph, (float)pc, mg, mh,
                                     mc, d, sg, sh, cnt, pout, hp);
        const bool t_ok = b <= (d ? max_t_r : max_t) && !skip_default;
        const float gain = (o.ok && t_ok && allowed && o.gain > mgs)
                               ? o.gain
                               : -INFINITY;
        const int idx = (d * F + f) * B + b;
        if (gain > best_g || (gain == best_g && idx < best_i)) {
          best_g = gain;
          best_i = idx;
        }
      }
    }
  }
  red_g[threadIdx.x] = best_g;
  red_i[threadIdx.x] = best_i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const float og = red_g[threadIdx.x + s];
      const int oi = red_i[threadIdx.x + s];
      if (og > red_g[threadIdx.x] ||
          (og == red_g[threadIdx.x] && oi < red_i[threadIdx.x])) {
        red_g[threadIdx.x] = og;
        red_i[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float bg = red_g[0];
  const int bi = red_i[0];
  const int d = bi / (F * B), f = (bi / B) % F, b = bi % B;
  const int nb = fmeta[f], mt = fmeta[F + f], db = fmeta[2 * F + f];
  const int mbin = mt == LGBT_MISSING_NAN
                       ? nb - 1
                       : (mt == LGBT_MISSING_ZERO ? db : -1);
  double tot[3], pre[3];
  sums(f, B - 1, mbin, nb, tot);
  sums(f, b, mbin, nb, pre);
  const LgbtCell o = lgbt_cell(
      (float)pre[0], (float)pre[1], (float)pre[2],
      __fsub_rn(sg, (float)tot[0]), __fsub_rn(sh, (float)tot[1]),
      __fsub_rn(cnt, (float)tot[2]), d, sg, sh, cnt, pout, hp);
  const float vals[LGBT_REC_FIELDS] = {
      isfinite(bg) ? __fsub_rn(bg, mgs) : -INFINITY,
      (float)f, (float)b, (float)d,
      lgbt_finite_or_zero(o.lg), lgbt_finite_or_zero(o.lh),
      lgbt_finite_or_zero(o.lc), lgbt_finite_or_zero(o.rg),
      lgbt_finite_or_zero(o.rh), lgbt_finite_or_zero(o.rc),
      lgbt_finite_or_zero(o.lout), lgbt_finite_or_zero(o.rout)};
#pragma unroll
  for (int r = 0; r < LGBT_REC_FIELDS; ++r) rec[r * n2 + j] = vals[r];
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
