"""Batch search on an IVF-Flat index: `IvfEngine.search_many_device`, the
bf16 bucket scan with its running top-C and the float32 rescore that
the `ivf` backend's `IvfSearcher` serves. The window, the recall and the
judged sample are `batch_search`'s.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch_search`'s
(`rate_metric`, `batch`, `batches_per_call`, `k`, `pool_calls`,
`sample_queries`, `profile_after_s`, `profile_s`), `nprobe` and
`rescore_factor` (C = rescore_factor x k candidates rescored).

Configuration: `batch_search`'s corpus keys (`n`, `d`, `metric`,
`clusters`, `center_scale`) and `ivf`: `lists` (k-means clusters),
`kmeans_iters`, `kmeans_seed` and `cap` (rows a bucket; null: 1.3 x the
mean occupancy).

The judged numbers beyond `batch_search`'s, against the plain IVF
reference (`benchmark/reference/ivf.py`) on the index's centres:
  assign_gap       the widest amount, on the score's scale, by which a
                   corpus row's best centre outscores its assigned one
                   (k-means' last assignment), over every row; the
                   reference builds its buckets from the assignment it
                   has checked
  probe_shortfall  1 - the mean overlap of the sample's answers with the
                   reference's top-k
  probe_rows_gap   the live rows the program's probes held, by its own
                   count (`ivf_search.rows`, in one call of the first
                   query group under a profiler session after the
                   window), outside the range the reference's probes
                   allow (a tie within rounding at the last probe goes
                   either way), a query
A program whose `ivf_search` counts no rows cannot be held to the last,
and the cell stops before its inputs are made.
"""

from __future__ import annotations

import time
from typing import Dict

from benchmark.drivers import batch_search
from benchmark.reference import ivf as ivf_ref
from benchmark.reference import judge


class Cell(batch_search.Cell):

    def inputs(self) -> None:
        if getattr(_program_search(), "rows", None) is None:
            raise RuntimeError(
                "leann_tpu_torch.ops.ivf.ivf_search counts no rows "
                "(ivf_search.rows): the cell's probe check cannot be made")
        super().inputs()

    def setup(self) -> None:
        from leann_tpu_torch.ops.ivf import IvfEngine

        c, iv = self.cfg, self.cfg["ivf"]
        t0 = time.perf_counter()
        self.engine = IvfEngine(
            self.corpus.numpy(), n_clusters=iv["lists"], metric=c["metric"],
            kmeans_iters=iv["kmeans_iters"], cap=iv["cap"],
            seed=iv["kmeans_seed"], device=self.dev)
        self.index = (self.engine.centers, self.engine.assign,
                      self.engine.cap)
        self.log(f"index built in {time.perf_counter() - t0:.1f} s: "
                 f"{self.engine.bucket_ids.shape[0]} buckets of "
                 f"{self.engine.cap} rows")
        self.kw = {"nprobe": self.tr["nprobe"],
                   "rescore_factor": self.tr["rescore_factor"]}
        for _ in range(2):          # the window's one shape, twice
            self._call(0)
        self.calls.clear()

    def launches(self) -> int:
        """The IVF path launches no hand-written kernel."""
        return 0

    def context(self, profile) -> Dict:
        """What the per-layer readers read: the profile, the batches
        inside the sub-window, `ivf_search` (its counter), and
        the bound's inputs: each batch of the first group's probes (the
        plain reference's, over the index's buckets), each bucket's live
        rows, the cap, the width and the candidates a query (C, as the
        engine clamps it)."""
        from leann_tpu_torch.ops.ivf import search_sizes

        centers, assign, cap = self.index
        _, cluster, members = ivf_ref.buckets(assign, len(centers), cap)
        cent, cluster = self._dev(centers), cluster.to(self.dev)
        probes = [ivf_ref.probe(q.to(self.dev), cent, cluster,
                                self.tr["nprobe"], self.cfg["metric"])
                  for q in self.groups[0]]
        _, _, c = search_sizes(self.engine, self.tr["k"], self.tr["nprobe"],
                               self.tr["rescore_factor"])
        ctx = {"profile": profile, "engine": "ivf",
               "ivf_search": _program_search(),
               "ivf_probes": probes, "ivf_live": (members >= 0).sum(1),
               "ivf_cap": cap, "d": self.cfg["d"], "ivf_candidates": c}
        if "calls1" in self.ctx:
            ctx["batches"] = ((self.ctx["calls1"] - self.ctx["calls0"])
                              * self.tr["batches_per_call"])
        return ctx

    def release(self) -> None:
        """Counts the rows of one more call before the engine goes."""
        if self.engine is not None:
            self.counted = self._count_rows()
        super().release()

    def _count_rows(self) -> tuple:
        """(live rows, queries) by the program's own count
        (`ivf_search.rows`) in one call of the first query group at the
        cell's batch and nprobe, under a profiler session."""
        from torch.profiler import ProfilerActivity, profile

        search = _program_search()
        rows0, queries0 = int(search.rows), search.traced_queries
        with profile(activities=[ProfilerActivity.CPU]):
            self.engine.search_many_device(self.groups[0].to(self.dev),
                                           self.tr["k"], **self.kw)
        search = _program_search()
        return int(search.rows) - rows0, search.traced_queries - queries0

    def _dev(self, array):
        import torch

        return torch.as_tensor(array).to(self.dev)

    # ------------------------------------------------------------ judge

    def judge(self) -> tuple:
        extra, numbers = super().judge()
        numbers.update(self._ivf_numbers(self.index[1]))
        return extra, numbers

    def _ivf_numbers(self, assign) -> Dict[str, float]:
        """`assign_gap` of `assign` (an assignment of every corpus row),
        and `probe_shortfall` and `probe_rows_gap` against the reference
        over the buckets of the assignment it checked."""
        import torch

        centers, _, cap = self.index
        metric, k, nprobe = self.cfg["metric"], self.tr["k"], self.tr["nprobe"]
        corpus = self.corpus.to(self.dev)
        gap, own = ivf_ref.check_assign(corpus, centers, assign, metric)
        moved = int((own != torch.as_tensor(assign).long()).sum())
        self.log(f"assign_gap {gap!r}: the reference moved {moved} rows")
        q, ids, _ = self.sample()
        ref_ids, _ = ivf_ref.topk(q, corpus, centers, own, k, nprobe, metric,
                                  cap=cap)
        overlap = judge.hits(ids.to(self.dev), ref_ids) / ref_ids.numel()

        _, cluster, members = ivf_ref.buckets(own, len(centers), cap)
        cent = self._dev(centers)
        cluster, members = cluster.to(self.dev), members.to(self.dev)
        lo = hi = ambiguous = 0
        for batch in self.groups[0]:
            got = ivf_ref.live_rows_range(batch.to(self.dev), cent, cluster,
                                          members, nprobe, metric)
            lo, hi, ambiguous = lo + got[0], hi + got[1], ambiguous + got[2]
        rows, queries = self.counted
        self.log(f"probed live rows: the program's {rows} for {queries} "
                 f"queries, the reference's {lo}-{hi} ({ambiguous} queries "
                 f"with a tie within rounding at the last probe)")
        return {"assign_gap": gap, "probe_shortfall": 1.0 - overlap,
                "probe_rows_gap": max(lo - rows, rows - hi, 0) / queries}

    def control(self, dtype, seconds: float) -> Dict[str, float]:
        """`batch_search`'s control (exact search at `dtype` in the
        program's place) with the IVF numbers: the index is built as a
        run builds it, for its centres (the reference's data); every
        corpus row is assigned by the reference at `dtype`, and the
        control's search reads every row for each query."""
        self.setup()
        self.release()
        numbers = super().control(dtype, seconds)
        queries = self.groups[0].shape[0] * self.groups[0].shape[1]
        self.counted = (self.cfg["n"] * queries, queries)
        low = ivf_ref.assign(self.corpus.to(self.dev), self.index[0],
                             self.cfg["metric"], dtype)
        numbers.update(self._ivf_numbers(low.cpu()))
        return numbers


def _program_search():
    """The program's `ivf_search` as its module holds it now."""
    from leann_tpu_torch.ops import ivf

    return ivf.ivf_search
