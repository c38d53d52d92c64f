"""Data-parallel tree training and sharded scoring over the process group.

Counterpart of lightgbm_tpu/parallel/data_parallel.py (the reference's
DataParallelTreeLearner, data_parallel_tree_learner.cpp): each rank builds
histograms on its own row block, the histogram exchange of the growers
(ops/grow_wave.py, ops/grow.py, ops/grow_fast.py) sums them, and every rank
then selects the same splits and grows the IDENTICAL tree, so no split
record is broadcast. The exchange is a full `psum` under
parallel_hist_mode=allreduce, or a `psum_scatter` of the feature-padded
buffer (each rank owning a feature slice, `FeatureSlice`) plus a best-split
merge under reduce_scatter.

The JAX package's `shard_map_compat` has no counterpart: a rank's code is
ordinary eager code on its own block.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from .context import DistContext, world


def lane_multiple() -> int:
    """The row-pad granularity of a rank's block: 128 on a TPU (its
    (8, 128) vector tiles), 8 everywhere else (data_parallel.py:49-72);
    the port never runs on a TPU."""
    return 8


def pad_rows_to(n: int, num_shards: int, multiple: int = 0) -> int:
    """Rows split evenly across the shards, each block padded to a
    multiple of `multiple` rows (0: `lane_multiple()`)."""
    if multiple <= 0:
        multiple = lane_multiple()
    per = -(-n // num_shards)
    per = -(-per // multiple) * multiple
    return per * num_shards


def shard_rows(arr: torch.Tensor, row_axis: int = 0,
               num_shards: int = 0, rank: int = -1,
               block: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `arr`'s rows (axis `row_axis`),
    padded with zeros to `block` rows, by default the per-rank block of
    `pad_rows_to`: rows [rank * block, (rank + 1) * block). The group's
    size and rank by default."""
    size, r, _ = world()
    num_shards = num_shards or size
    rank = r if rank < 0 else rank
    n = arr.shape[row_axis]
    per = block or pad_rows_to(n, num_shards) // num_shards
    lo = min(rank * per, n)
    got = min(per, n - lo)
    if (lo, got) == (0, n) and per == n:
        return arr
    b = arr.narrow(row_axis, lo, got)
    if got < per:
        pad = list(b.shape)
        pad[row_axis] = per - got
        b = torch.cat([b, b.new_zeros(pad)], dim=row_axis)
    return b.contiguous()


def replicated(arr: torch.Tensor) -> torch.Tensor:
    """An array every rank holds whole (the model, feature-parallel's
    rows): each process keeps its own copy."""
    return arr


class FeatureSlice(NamedTuple):
    """The features a rank owns (data_parallel_tree_learner.cpp:72-122,
    PrepareBufferPos): the feature axis padded to Fh_pad = round_up(F, W),
    rank r owning [r * Fs, (r + 1) * Fs). Padded features get num_bins 0,
    so every bin of theirs gains -inf."""
    F: int
    Fh_pad: int
    Fs: int
    foff: int

    @classmethod
    def of(cls, F: int, num_shards: int, rank: int) -> "FeatureSlice":
        fh = -(-F // num_shards) * num_shards
        fs = fh // num_shards
        return cls(F, fh, fs, rank * fs)

    def pad(self, a: torch.Tensor, axis: int, fill=0) -> torch.Tensor:
        """`a` with its feature axis padded to Fh_pad."""
        n = a.shape[axis]
        if n == self.Fh_pad:
            return a
        shape = list(a.shape)
        shape[axis] = self.Fh_pad - n
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                        device=a.device)], dim=axis)

    def take(self, a: Optional[torch.Tensor], axis: int = -1, fill=0
             ) -> Optional[torch.Tensor]:
        """This rank's slice of `a`'s feature axis (padded first)."""
        if a is None:
            return None
        return self.pad(a, axis, fill).narrow(axis, self.foff, self.Fs)

    def meta(self, meta):
        """The search metadata of the owned slice (grow_wave.py:505-517);
        the forced table keeps global feature ids."""
        return meta._replace(
            num_bins=self.take(meta.num_bins, 0),
            missing_type=self.take(meta.missing_type, 0),
            default_bin=self.take(meta.default_bin, 0),
            is_categorical=self.take(meta.is_categorical, 0),
            monotone=self.take(meta.monotone, 0),
            inter_sets=self.take(meta.inter_sets, 1),
            cegb_coupled=self.take(meta.cegb_coupled, 0))


def build_data_parallel_train_fn(meta, cfg, grow_fn=None,
                                 replicate_rows: bool = False,
                                 dist: Optional[DistContext] = None):
    """The data-parallel step with the signature of the serial one:

        (X_t [F, n], grad [n], hess [n], in_bag [n], scores_k [n] or None,
         lr, feature_mask [F], seed)
        -> (DeviceTree, leaf_of_row [n], new_scores [n] or None)

    on this rank's block of n rows (pad with in_bag == 0 rows via
    `pad_rows_to`): the tree grown with the group's histogram exchange,
    then the score update (#2) on the block. `grow_fn` is the wave grower
    (default), ops/grow.py:grow_tree or ops/grow_fast.py:grow_tree_fast.
    `replicate_rows` is feature-parallel: every rank holds all rows and
    histograms its own feature slice (cfg.feature_parallel)."""
    from ..ops.grow_wave import grow_tree_wave
    from ..ops.histogram import add_leaf_values_
    grow_fn = grow_fn or grow_tree_wave
    dist = dist or DistContext()
    if replicate_rows and not cfg.feature_parallel:
        cfg = cfg._replace(feature_parallel=True)
    takes_seed = grow_fn is grow_tree_wave

    def step(X_t, grad, hess, in_bag, scores_k, lr, feat_mask, seed):
        kw = dict(dist=dist)
        if takes_seed:
            kw["rng_seed"] = seed
        tree, leaf_of_row = grow_fn(X_t, grad, hess, in_bag, meta, cfg,
                                    feat_mask, **kw)
        if scores_k is None:
            return tree, leaf_of_row, None
        new_scores = scores_k.clone()
        add_leaf_values_(new_scores, tree.leaf_value * lr, leaf_of_row)
        return tree, leaf_of_row, new_scores
    return step


def build_sharded_score_fn(devices: Sequence,
                           score_fn: Union[Callable, Sequence[Callable]],
                           extra_row_args: int = 0) -> Callable:
    """Data-parallel scoring (the JAX shard_map twin, data_parallel.py:
    116-140), with no collective: a batch of rows splits into one
    contiguous block per listed device, each block is scored on its
    device, and the [K, n] margins come back concatenated on the first
    device. `score_fn(X [b, F], *extras) -> [K, b]` (one callable for
    every device, or one per device, holding that device's copy of the
    model); `extra_row_args` per-row 1-D operands (the fused scorer's
    tenant ids) split the same way. The row count must divide into the
    devices (pad with `pad_rows_to`)."""
    devs = [torch.device(d) for d in devices]
    fns = list(score_fn) if isinstance(score_fn, (list, tuple)) \
        else [score_fn] * len(devs)
    if len(fns) != len(devs):
        raise ValueError("build_sharded_score_fn: one score_fn per device")

    def sharded(X: torch.Tensor, *extras: torch.Tensor) -> torch.Tensor:
        if len(extras) != extra_row_args:
            raise TypeError(f"sharded scorer takes {extra_row_args} extra "
                            f"row operands, got {len(extras)}")
        n = X.shape[0]
        if n % len(devs):
            raise ValueError(f"{n} rows do not split over {len(devs)} "
                             "devices (pad with pad_rows_to)")
        b = n // len(devs)
        outs = []
        for i, (d, fn) in enumerate(zip(devs, fns)):
            sl = slice(i * b, (i + 1) * b)
            outs.append(fn(X[sl].to(d), *[e[sl].to(d) for e in extras]))
        return torch.cat([o.to(devs[0]) for o in outs], dim=1)
    return sharded
