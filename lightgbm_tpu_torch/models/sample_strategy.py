"""Data sampling strategies: bagging and GOSS.

Counterpart of lightgbm_tpu/models/sample_strategy.py (reference:
src/boosting/sample_strategy.cpp:16, bagging.hpp:15, goss.hpp:19).
Sampling gives a dense [N] multiplier on the training device: 0 for
out-of-bag rows, 1 in bag, (1 - top_rate) / other_rate for the rows GOSS
amplifies. The grower multiplies the gradients and hessians by it and
counts the rows where it is positive.

Uniform bagging and GOSS draw from the port's threefry
(utils/random.py), bit for bit the JAX package's `jax.random` draws, and
each mask is a function of the iteration alone; class-stratified and
by-query bagging draw with NumPy, as the JAX package does.

The batched trainer's contract (sample_strategy.py:14-23 of the JAX
package): a strategy with `supports_scan` gives its mask as
`mask_for_iter(it, grad, hess)`, a pure tensor function of the iteration
(an int, or an int64 tensor on the device that a captured CUDA graph
reads) and, for GOSS (`needs_grad`), of the gradients; it equals
`sample(it, ...)` bit for bit. Class-stratified and by-query bagging keep
`supports_scan = False`: their NumPy draws stay on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..utils.log import log_fatal, log_warning
from ..utils.random import PRNGKey, device_key, fold_in, uniform


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest value of x (1-based), by a sort: on CUDA
    torch.kthvalue selects in one block, which takes milliseconds at
    2^20 values."""
    return torch.sort(x).values[k - 1]


class SampleStrategy:
    """No sampling: every row in bag, drawn once."""

    needs_grad = False       # sample() reads the gradients
    supports_scan = True     # mask_for_iter is a tensor function of `it`

    def __init__(self, config: Config, num_data: int, metadata,
                 device: torch.device):
        self.config = config
        self.num_data = num_data
        self.metadata = metadata
        self.device = device

    def resample_period(self) -> int:
        """0: the mask never changes after iteration 0; p > 0: a new mask
        every p iterations."""
        return 0

    def resamples_at(self, it: int) -> bool:
        """Whether sample() gives a new mask at iteration `it`."""
        p = self.resample_period()
        return p > 0 and it % p == 0

    def sample(self, it: int, grad: Optional[torch.Tensor] = None,
               hess: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The [N] f32 in-bag multiplier of iteration `it` (GOSS reads the
        [N] or [K, N] gradients and hessians, the others do not)."""
        return torch.ones(self.num_data, dtype=torch.float32,
                          device=self.device)

    def mask_for_iter(self, it, grad: Optional[torch.Tensor] = None,
                      hess: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mask of iteration `it` (an int or an int64 device tensor),
        read from no host value; bitwise `sample(it, grad, hess)`."""
        return torch.ones(self.num_data, dtype=torch.float32,
                          device=self.device)


class BaggingSampleStrategy(SampleStrategy):
    """reference: bagging.hpp:15. A new mask every `bagging_freq`
    iterations keeping `bagging_fraction` of the rows (pos / neg
    fractions: of the positive and the negative rows; bagging_by_query:
    of the queries, each whole)."""

    def __init__(self, config: Config, num_data: int, metadata,
                 device: torch.device):
        super().__init__(config, num_data, metadata, device)
        self._balanced = (config.pos_bagging_fraction < 1.0
                          or config.neg_bagging_fraction < 1.0)
        if self._balanced and metadata.label is None:
            log_warning("pos/neg bagging needs labels; falling back to "
                        "uniform bagging")
            self._balanced = False
        self._by_query = bool(config.bagging_by_query)
        if self._by_query and metadata.query_boundaries is None:
            log_fatal("bagging_by_query requires query/group information")
        if self._by_query and self._balanced:
            log_warning("bagging_by_query ignores pos/neg bagging "
                        "fractions (query-level sampling)")
            self._balanced = False
        self.supports_scan = not (self._balanced or self._by_query)
        self._cnt = max(1, int(num_data * config.bagging_fraction))
        self._key = PRNGKey(config.bagging_seed)
        self._dkey = device_key(self._key, device)

    def resample_period(self) -> int:
        return max(self.config.bagging_freq, 1)

    def _floor_iter(self, it: int) -> int:
        freq = self.resample_period()
        return (it // freq) * freq

    def sample(self, it, grad=None, hess=None):
        it_r = self._floor_iter(it)
        if self._by_query:
            return self._by_query_mask(it_r)
        if self._balanced:
            return self._stratified(it_r)
        return self.mask_for_iter(it_r)

    def mask_for_iter(self, it, grad=None, hess=None):
        # keyed by the floored iteration: a bagging window shares one
        # key; the `cnt` smallest uniforms are in bag (the JAX package's
        # top_k threshold; a draw equal to it is in bag too)
        key = self._dkey if isinstance(it, torch.Tensor) else self._key
        u = uniform(fold_in(key, self._floor_iter(it)), (self.num_data,),
                    self.device)
        return (u <= _kth_smallest(u, self._cnt)).to(torch.float32)

    def _by_query_mask(self, it_r: int) -> torch.Tensor:
        """Whole queries in or out of bag: max(1, int(Q * fraction)) of the
        Q queries drawn without replacement (sample_strategy.py:131-147)."""
        rng = np.random.RandomState(self.config.bagging_seed + it_r)
        qb = np.asarray(self.metadata.query_boundaries, np.int64)
        nq = len(qb) - 1
        keep = rng.choice(nq, max(int(nq * self.config.bagging_fraction), 1),
                          replace=False)
        flags = np.zeros(nq, np.float32)
        flags[keep] = 1.0
        return torch.from_numpy(np.repeat(flags, np.diff(qb))).to(
            self.device)

    def _stratified(self, it_r: int) -> torch.Tensor:
        rng = np.random.RandomState(self.config.bagging_seed + it_r)
        label = np.asarray(self.metadata.label)
        pos = np.flatnonzero(label > 0)
        neg = np.flatnonzero(label <= 0)
        n_pos = int(len(pos) * self.config.pos_bagging_fraction)
        n_neg = int(len(neg) * self.config.neg_bagging_fraction)
        mask = np.zeros(self.num_data, dtype=np.float32)
        mask[rng.choice(pos, n_pos, replace=False)] = 1.0
        mask[rng.choice(neg, n_neg, replace=False)] = 1.0
        return torch.from_numpy(mask).to(self.device)


class GOSSStrategy(SampleStrategy):
    """Gradient-based One-Side Sampling (reference: goss.hpp:19): keep the
    top_rate share of rows by |grad * hess|, accept each other row with
    probability other_k / (N - top_k) and amplify it by
    (1 - top_rate) / other_rate; every row for the first
    int(1 / learning_rate) iterations."""

    needs_grad = True

    def __init__(self, config: Config, num_data: int, metadata,
                 device: torch.device):
        super().__init__(config, num_data, metadata, device)
        self.top_k = max(1, int(num_data * config.top_rate))
        self.other_k = max(1, int(num_data * config.other_rate))
        self.warmup_iters = int(1.0 / config.learning_rate)
        self._key = PRNGKey(config.data_random_seed)
        self._dkey = device_key(self._key, device)

    def resample_period(self) -> int:
        return 1

    def sample(self, it, grad=None, hess=None):
        if it < self.warmup_iters:
            return super().sample(it)
        return self._goss_mask(it, grad, hess)

    def mask_for_iter(self, it, grad=None, hess=None):
        # every row in bag through the warm-up: a select, not a branch, so
        # `it` may be a device tensor
        if not isinstance(it, torch.Tensor):
            return self.sample(it, grad, hess)
        ones = torch.ones(self.num_data, dtype=torch.float32,
                          device=self.device)
        return torch.where(it < self.warmup_iters, ones,
                           self._goss_mask(it, grad, hess))

    def _goss_mask(self, it, grad, hess):
        N = self.num_data
        g_abs = torch.abs(grad * hess)
        if g_abs.dim() == 2:
            # summed over the classes (goss.hpp Bagging; sample_strategy.py:
            # 188-191), in class order
            acc = g_abs[0].clone()
            for row in g_abs[1:]:
                acc += row
            g_abs = acc
        # the top_k-th largest magnitude; ties with it are kept too
        is_top = g_abs >= _kth_smallest(g_abs, N - self.top_k + 1)
        key = self._dkey if isinstance(it, torch.Tensor) else self._key
        u = uniform(fold_in(key, it), (N,), self.device)

        def f32(v):
            # the JAX package compares and scales in f32 (weakly typed
            # Python floats); a fill, not a copy from the host, so a
            # captured graph may hold it
            return torch.full((), v, dtype=torch.float32,
                              device=self.device)
        p_accept = f32(self.other_k / max(N - self.top_k, 1))
        sampled = ~is_top & (u < p_accept)
        mult = f32((1.0 - self.config.top_rate) / self.config.other_rate)
        return is_top.to(torch.float32) + sampled.to(torch.float32) * mult


def create_sample_strategy(config: Config, num_data: int, metadata,
                           device: torch.device) -> SampleStrategy:
    """reference: SampleStrategy::CreateSampleStrategy
    (sample_strategy.cpp:16)."""
    if config.data_sample_strategy == "goss":
        return GOSSStrategy(config, num_data, metadata, device)
    if config.bagging_freq > 0 and (
            config.bagging_fraction < 1.0
            or config.pos_bagging_fraction < 1.0
            or config.neg_bagging_fraction < 1.0):
        return BaggingSampleStrategy(config, num_data, metadata, device)
    return SampleStrategy(config, num_data, metadata, device)
