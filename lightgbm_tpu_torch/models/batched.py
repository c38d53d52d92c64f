"""Batched training's runner: a chunk of boosting iterations with no host
round trip per iteration.

Counterpart of the JAX package's whole-chunk `lax.scan`
(lightgbm_tpu/models/gbdt.py:1206-1398, `train_iters_batched` and
`_get_scan_fn`) and of its tree drain (`_AsyncTreeDrain`, :2254-2323). A
tree's waves depend on the data and the installed torch exposes no
conditional graph node, so one graph per chunk cannot hold; each tree
replays three CUDA graphs instead, captured once per runner:

  * "start": the gradients of the scores, the in-chunk bagging or GOSS
    mask (`mask_for_iter`), the discretized gradients and the root pass
    (ops/grow_batched.py:WaveStepper.start, SerialStepper.start);
  * "wave", or "split" on the serial growers masked and compact: one
    fixed-shape step (WaveStepper.wave, SerialStepper.split), replayed
    LAG at a time; after each group the host copies the step's `more` flag
    into pinned memory behind an event and reads it, so a tree of w steps
    costs ceil(w / LAG) blocking reads (one when it has none) and runs
    at most LAG - 1 inert steps;
  * "finish": leaf renewal, the score update (#2) of the training rows
    and of each valid set, whose rows the waves relabelled, the metric
    row written into the [chunk, M] buffer, and the tree record written
    into the chunk's stacked record.

Every per-iteration value a graph reads lives in a static device buffer:
the host fills the chunk's table (iteration, tree seed, slot, the
feature_fraction masks drawn from the host RandomState as before) once a
chunk, and one device-to-device copy an iteration selects its row before
the replays; the learning rate is filled once a chunk. A graph's first
call runs its step eagerly (the real step, building and loading every
kernel), then captures it; a capture that fails raises. The kernels'
launch counts advance only at capture, so each replay adds the launches
its graph captured (`hc.LAUNCHES` counts real launches either way).

On the CPU the same runner calls the same step functions eagerly, and
reads the flag directly: the tests' path.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import histogram_cuda as hc
from ..ops.grow_batched import TREE_FIELDS, make_stepper

# steps (waves or splits) replayed between two polls of the tree's `more`
# flag
LAG = 4


class ChunkRunner:
    """The buffers, graphs and counters of one batched-training key."""

    def __init__(self, gbdt, chunk: int, mode: str, layout):
        dev = gbdt.device
        self.gbdt = gbdt
        self.cuda = dev.type == "cuda"
        self.chunk = chunk
        self.mode = mode
        st = self.stepper = make_stepper(
            gbdt.grower, gbdt.X_t, gbdt.meta, gbdt.grow_cfg,
            hist_plan=gbdt.hist_plan, valid_X=gbdt._valid_Xt,
            leaf_map=gbdt.leaf_map)
        N, F = gbdt.num_data, len(gbdt.mappers)

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.scores = z((1, N))
        self.vscores = [torch.zeros_like(v) for v in gbdt._valid_scores]
        self.bag = torch.ones(N, device=dev)
        self.has_fmask = gbdt.config.feature_fraction < 1.0
        # the chunk's table: (iteration, tree seed, slot) a row, and the
        # current iteration's row and mask
        self.tab = z((chunk, 3), torch.int64)
        self.tab_fmask = z((chunk, F), torch.bool)
        self.cur = z(3, torch.int64)
        self.cur_fmask = z(F, torch.bool)
        self.lr = z(())
        # the valid sets' metric operands
        self.metric_fns = [(vi, fn) for vi, _, fn in (layout or [])]
        self.vlabel, self.vweight, self.vsumw = [], [], []
        for ds in gbdt.valid_sets:
            md = ds.metadata
            self.vlabel.append(torch.as_tensor(
                np.asarray(md.label, np.float32)).to(dev))
            w = (np.ones(ds.num_data, np.float32) if md.weight is None
                 else np.asarray(md.weight, np.float32))
            self.vweight.append(torch.as_tensor(w).to(dev))
            sw = float(ds.num_data) if md.weight is None \
                else float(np.sum(md.weight))
            self.vsumw.append(torch.full((), sw, dtype=torch.float32,
                                         device=dev))
        self.mbuf = z((chunk, len(self.metric_fns)))
        tree = st.device_tree()
        self.stack = {k: z((chunk,) + tuple(getattr(tree, k).shape),
                           getattr(tree, k).dtype) for k in TREE_FIELDS}
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.captured: Dict[str, Dict[str, int]] = {}
        self.captures = collections.Counter()
        self.replays = collections.Counter()
        # per tree grown: blocking host reads of its `more` flag, steps
        # (waves or splits) run; seconds each capture took
        self.tree_reads: List[int] = []
        self.tree_waves: List[int] = []
        self.capture_s: Dict[str, float] = {}
        if self.cuda:
            self.flag_host = torch.zeros(1, dtype=torch.int32,
                                         pin_memory=True)
            self.flag_event = torch.cuda.Event()

    # ------------------------------------------------------------------
    # the three steps, each a function of the static buffers alone
    def _start(self) -> None:
        gb = self.gbdt
        g, h = gb.objective.get_gradients(self.scores[0], gb.label_dev,
                                          gb.weight_dev)
        bag = (gb.sample_strategy.mask_for_iter(self.cur[0], g, h)
               if self.mode == "scan" else self.bag)
        self.stepper.start(g, h, bag,
                           self.cur_fmask if self.has_fmask else None,
                           self.cur[1])

    def _step(self) -> None:
        self.stepper.step()

    def _finish(self) -> None:
        st = self.stepper
        st.finish(self.lr, self.scores[0], [v[0] for v in self.vscores])
        slot = self.cur[2:3]
        if self.metric_fns:
            vals = torch.stack([
                fn(self.vscores[vi], self.vlabel[vi], self.vweight[vi],
                   self.vsumw[vi]) for vi, fn in self.metric_fns])
            self.mbuf.index_copy_(0, slot, vals[None].to(torch.float32))
        tree = st.device_tree()
        for k in TREE_FIELDS:
            self.stack[k].index_copy_(0, slot, getattr(tree, k)[None])

    def _call(self, name: str, fn) -> None:
        """Run step `name`: replay its graph; on the first call run it
        eagerly and capture it (CUDA), or run it (CPU)."""
        if not self.cuda:
            fn()
            return
        graph = self.graphs.get(name)
        if graph is not None:
            graph.replay()
            self.replays[name] += 1
            for k, v in self.captured[name].items():
                hc.LAUNCHES[k] += v
            return
        fn()
        before = dict(hc.LAUNCHES)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
        self.capture_s[name] = time.perf_counter() - t0
        self.captured[name] = {k: hc.LAUNCHES[k] - before[k]
                               for k in before if hc.LAUNCHES[k] != before[k]}
        hc.LAUNCHES.update(before)
        self.graphs[name] = graph
        self.captures[name] += 1

    def _more(self) -> bool:
        """The tree's `more` flag: one blocking host read."""
        if not self.cuda:
            return bool(self.stepper.more)
        self.flag_host.copy_(self.stepper.more.reshape(1), non_blocking=True)
        self.flag_event.record()
        self.flag_event.synchronize()
        return bool(self.flag_host[0])

    # ------------------------------------------------------------------
    def run(self, n: int, its: List[int], seeds: List[int],
            masks: Optional[np.ndarray], lr: float,
            in_bag: Optional[torch.Tensor]) -> None:
        """Grow n trees, iteration its[i] with tree seed seeds[i] and
        feature_fraction mask masks[i] ([n, F] bool, None: no mask), each
        into slot i of the chunk's record and metric buffer."""
        gb = self.gbdt
        rows = np.stack([np.asarray(its, np.int64),
                         np.asarray(seeds, np.int64),
                         np.arange(n, dtype=np.int64)], axis=1)
        self.tab[:n].copy_(torch.from_numpy(rows))
        if self.has_fmask:
            self.tab_fmask[:n].copy_(torch.from_numpy(masks))
        self.lr.fill_(lr)
        self.scores.copy_(gb.scores)
        for vs, src in zip(self.vscores, gb._valid_scores):
            vs.copy_(src)
        if in_bag is not None:
            self.bag.copy_(in_bag)
        for i in range(n):
            self.cur.copy_(self.tab[i])
            if self.has_fmask:
                self.cur_fmask.copy_(self.tab_fmask[i])
            self._call("start", self._start)
            reads = 0
            while True:
                for _ in range(LAG):
                    self._call(self.stepper.step_name, self._step)
                reads += 1
                if not self._more():
                    break
            self.tree_reads.append(reads)
            self.tree_waves.append(reads * LAG)
            self._call("finish", self._finish)
        gb.scores.copy_(self.scores)
        for vs, dst in zip(self.vscores, gb._valid_scores):
            dst.copy_(vs)

    def record(self, n: int, to_host: bool):
        """(the chunk's first n tree records {field: [n, ...]}, an event):
        copied to pinned host memory behind the event (to_host on the
        card, the drain's form), else cloned where they are (no event)."""
        if not to_host or not self.cuda:
            return {k: v[:n].clone() for k, v in self.stack.items()}, None
        rec = {k: torch.empty(v[:n].shape, dtype=v.dtype, pin_memory=True)
               for k, v in self.stack.items()}
        for k, v in rec.items():
            v.copy_(self.stack[k][:n], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return rec, ev


class AsyncTreeDrain:
    """The worker that turns chunk records into host trees while the next
    chunk runs (JAX gbdt.py:2254-2323). The main thread submits (record,
    event, biases, learning rate) after each chunk; the worker waits on
    the record's copy event and converts; `flush` folds the converted
    trees into the model in submission order and re-raises a worker's
    error. `lags_ms` holds, per chunk, the time from submission to its
    trees' conversion."""

    def __init__(self, gbdt):
        self._gbdt = gbdt
        self._q: "queue.Queue" = queue.Queue()
        self._done: List[list] = []
        self._error: Optional[BaseException] = None
        self.lags_ms: List[float] = []
        self._thread = threading.Thread(
            target=self._run, name="gbdt-tree-drain", daemon=True)
        self._thread.start()

    def submit(self, item) -> None:
        self._q.put((time.perf_counter(), item))

    def _run(self) -> None:
        while True:
            t0, item = self._q.get()
            try:
                if item is None:
                    return
                if self._error is not None:
                    continue
                (rec, ev), biases, lr = item
                if ev is not None:
                    ev.synchronize()
                self._done.append(self._gbdt._record_to_trees(rec, biases,
                                                              lr))
                self.lags_ms.append((time.perf_counter() - t0) * 1e3)
            except BaseException as e:   # raised again by flush()
                self._error = e
            finally:
                self._q.task_done()

    def flush(self) -> None:
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        done, self._done = self._done, []
        for trees in done:
            self._gbdt._models.extend(trees)

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._q.put((0.0, None))
            self._thread.join(timeout=10.0)
