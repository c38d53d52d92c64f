"""Ranking objectives: LambdaRank (NDCG-weighted pairwise) and RankXENDCG.

Counterpart of lightgbm_tpu/objectives/rank.py (the reference's
src/objective/rank_objective.hpp:26-370).

LambdaRank runs on the scores' device as plain tensor code, as the JAX
package runs it in XLA (no Pallas kernel): queries are bucketed by their
padded power-of-two length; each bucket gathers its scores into a dense
[num_queries, padded_len] block through fixed index matrices, sorts each
query (stably, on -score with +inf padding: at iteration 0 every score
ties and the order is the index order) and accumulates the truncated pair
block's lambdas along the pair axes, so no scatter is needed.

RankXENDCG stays on the host: it draws fresh uniforms every iteration from
np.random.RandomState(objective_seed), query by query in query order
(rank_objective.hpp:330), so its draws are bitwise the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config
from ..metrics.rank_utils import default_label_gain
from ..utils.log import log_fatal
from . import ObjectiveFunction

_KEPS = 1e-15


class RankingObjective(ObjectiveFunction):
    """Base (reference: rank_objective.hpp:37)."""
    runs_on_host = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.seed = config.objective_seed

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log_fatal("Ranking tasks require query information")
        self.query_boundaries = metadata.query_boundaries
        self.num_queries = len(self.query_boundaries) - 1

    def get_gradients_numpy(self, score: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """[N] f32 gradients and hessians of [N] scores, query by query."""
        score = np.asarray(score, np.float64).reshape(-1)
        grad = np.zeros(self.num_data, dtype=np.float32)
        hess = np.zeros(self.num_data, dtype=np.float32)
        qb = self.query_boundaries
        for q in range(self.num_queries):
            s, e = int(qb[q]), int(qb[q + 1])
            grad[s:e], hess[s:e] = self._one_query(q, self.label[s:e],
                                                   score[s:e])
        if self.weight is not None:
            grad *= self.weight
            hess *= self.weight
        return grad, hess

    def _one_query(self, qid, label, score):
        raise NotImplementedError


class LambdarankNDCG(RankingObjective):
    """reference: rank_objective.hpp:137-300; on the device."""
    name = "lambdarank"
    runs_on_host = False

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            log_fatal(f"Sigmoid param {self.sigmoid} should be greater "
                      "than zero")
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.label_gain = (np.asarray(config.label_gain, np.float64)
                           if len(config.label_gain)
                           else default_label_gain())

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if np.any(self.label < 0):
            log_fatal("Label should be non-negative for lambdarank")
        if int(np.max(self.label)) >= len(self.label_gain):
            log_fatal("Label exceeds label_gain size; set label_gain")
        # inverse max DCG at the truncation level per query (Init,
        # rank_objective.hpp:160-178)
        qb = self.query_boundaries
        self.inverse_max_dcgs = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            lbl = self.label[qb[q]:qb[q + 1]].astype(np.int64)
            top = np.sort(lbl)[::-1][:self.truncation_level]
            max_dcg = float(np.sum(self.label_gain[top]
                                   / np.log2(np.arange(2, len(top) + 2))))
            self.inverse_max_dcgs[q] = 1.0 / max_dcg if max_dcg > 0 else 0.0
        self._buckets_np = self._build_buckets()
        self._buckets_dev = None

    def _build_buckets(self):
        """Queries bucketed by padded (power-of-two, at least 8) length;
        per bucket the fixed host arrays: row indices into the flat score
        vector (N = the zero sentinel), label gains and ids (-1 padding),
        query lengths and inverse max DCGs; and the inverse map from
        bucket space back to rows."""
        qb = np.asarray(self.query_boundaries, np.int64)
        lengths = np.diff(qb)
        N = self.num_data
        by_len = {}
        for q, ln in enumerate(lengths):
            plen = 1 << max(3, int(np.ceil(np.log2(max(ln, 1)))))
            by_len.setdefault(plen, []).append(q)
        buckets = []
        pos_of_row = np.zeros(N, np.int64)
        offset = 0
        for plen in sorted(by_len):
            qs = by_len[plen]
            nq = len(qs)
            idx = np.full((nq, plen), N, np.int64)
            lab = np.full((nq, plen), -1, np.int32)
            cnt = np.zeros(nq, np.int64)
            imd = np.zeros(nq, np.float32)
            for i, q in enumerate(qs):
                s, e = int(qb[q]), int(qb[q + 1])
                ln = e - s
                idx[i, :ln] = np.arange(s, e)
                lab[i, :ln] = self.label[s:e].astype(np.int32)
                cnt[i] = ln
                imd[i] = self.inverse_max_dcgs[q]
                pos_of_row[s:e] = offset + i * plen + np.arange(ln)
            gain = np.where(lab >= 0, self.label_gain[np.maximum(lab, 0)],
                            0.0).astype(np.float32)
            buckets.append(dict(plen=plen, idx=idx, gain=gain, lab=lab,
                                cnt=cnt, imd=imd))
            offset += nq * plen
        return buckets, pos_of_row

    def _device_buckets(self, device):
        if self._buckets_dev is None or self._buckets_dev[0] != device:
            buckets, pos_of_row = self._buckets_np
            self._buckets_dev = (device, [
                {k: (v if k == "plen" else torch.from_numpy(v).to(device))
                 for k, v in bk.items()} for bk in buckets],
                torch.from_numpy(pos_of_row).to(device))
        return self._buckets_dev[1], self._buckets_dev[2]

    def get_gradients(self, score, label, weight):
        """LambdaRank's lambdas and hessians of [N] f32 scores
        (GetGradientsForOneQuery, rank_objective.hpp:188-260), vectorized
        over the bucketed queries as JAX objectives/rank.py:139-253."""
        dev = score.device
        buckets, pos_of_row = self._device_buckets(dev)
        s_ext = torch.cat([score.to(torch.float32),
                           torch.zeros(1, dtype=torch.float32, device=dev)])
        sig = self.sigmoid
        outs_g, outs_h = [], []
        for bk in buckets:
            plen = bk["plen"]
            s = s_ext[bk["idx"]]                               # [nq, plen]
            cnt = bk["cnt"][:, None]
            posn = torch.arange(plen, device=dev)[None, :]
            key = torch.where(posn < cnt, -s, torch.full_like(s, np.inf))
            order = torch.sort(key, dim=1, stable=True).indices
            ss = torch.gather(s, 1, order)
            gn = torch.gather(bk["gain"], 1, order)
            lb = torch.gather(bk["lab"], 1, order)
            Ti = min(plen - 1, self.truncation_level)
            Ii = torch.arange(Ti, device=dev)
            Jj = torch.arange(plen, device=dev)
            lbi, lbj = lb[:, :Ti, None], lb[:, None, :]
            pair_ok = ((Jj[None, None, :] > Ii[None, :, None])
                       & (Jj[None, None, :] < cnt[:, :1, None])
                       & (lbi != lbj) & (lbi >= 0) & (lbj >= 0))
            disc = 1.0 / torch.log2(2.0 + Jj.to(torch.float32))
            dcg_gap = torch.abs(gn[:, :Ti, None] - gn[:, None, :])
            pdisc = torch.abs(disc[None, :Ti, None] - disc[None, None, :])
            delta_ndcg = dcg_gap * pdisc * bk["imd"][:, None, None]
            hi_is_i = lbi > lbj
            dscore = torch.where(hi_is_i,
                                 ss[:, :Ti, None] - ss[:, None, :],
                                 ss[:, None, :] - ss[:, :Ti, None])
            if self.norm:
                best = ss[:, :1]
                worst = torch.gather(ss, 1, torch.clamp(cnt - 1, min=0))
                delta_ndcg = torch.where(
                    (best != worst)[:, :, None],
                    delta_ndcg / (0.01 + torch.abs(dscore)), delta_ndcg)
            p0 = 1.0 / (1.0 + torch.exp(sig * dscore))
            m = pair_ok.to(torch.float32)
            p_l = -sig * delta_ndcg * p0 * m
            p_h = sig * sig * delta_ndcg * p0 * (1.0 - p0) * m
            # both pair sides reduce along an axis: no scatter
            li = torch.where(hi_is_i, p_l, -p_l).sum(dim=2)    # [nq, Ti]
            ljc = torch.where(hi_is_i, -p_l, p_l).sum(dim=1)   # [nq, plen]
            lam_sorted = ljc.clone()
            lam_sorted[:, :Ti] += li
            hes_sorted = p_h.sum(dim=1)
            hes_sorted[:, :Ti] += p_h.sum(dim=2)
            if self.norm:
                sum_l = -2.0 * p_l.sum(dim=(1, 2))
                nf = torch.where(sum_l > 0,
                                 torch.log2(1.0 + sum_l)
                                 / torch.clamp(sum_l, min=_KEPS),
                                 torch.ones_like(sum_l))
                lam_sorted = lam_sorted * nf[:, None]
                hes_sorted = hes_sorted * nf[:, None]
            # back from sorted positions to each query's own order
            lam = torch.empty_like(lam_sorted).scatter_(1, order, lam_sorted)
            hes = torch.empty_like(hes_sorted).scatter_(1, order, hes_sorted)
            outs_g.append(lam.reshape(-1))
            outs_h.append(hes.reshape(-1))
        g = torch.cat(outs_g)[pos_of_row]
        h = torch.cat(outs_h)[pos_of_row]
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h

    def to_string(self):
        return "lambdarank"


class RankXENDCG(RankingObjective):
    """Cross-entropy NDCG surrogate (reference: rank_objective.hpp:302-370);
    on the host."""
    name = "rank_xendcg"

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        self._rng = np.random.RandomState(self.seed)

    def _one_query(self, qid, label, score):
        cnt = len(label)
        if cnt <= 1:
            return np.zeros(cnt), np.zeros(cnt)
        rho = np.exp(score - np.max(score))
        rho /= np.sum(rho)
        # Phi(l, g) = 2^l - g, a uniform g per document
        params = np.power(2.0, label.astype(np.int64)) \
            - self._rng.uniform(size=cnt)
        inv_denominator = 1.0 / max(_KEPS, float(np.sum(params)))
        # first order
        term1 = -params * inv_denominator + rho
        lambdas = term1.copy()
        params = term1 / (1.0 - rho)
        sum_l1 = float(np.sum(params))
        # second order
        term2 = rho * (sum_l1 - params)
        lambdas += term2
        params = term2 / (1.0 - rho)
        sum_l2 = float(np.sum(params))
        # third order
        lambdas += rho * (sum_l2 - params)
        return lambdas, rho * (1.0 - rho)

    def to_string(self):
        return "rank_xendcg"
