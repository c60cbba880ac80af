"""Batch search: groups of query batches copied from host memory to the
engine's `search_many_device`, their ids and scores copied back.

Traffic parameters (`benchmark/traffic/<mix>.json`): `engine` (`vamana`:
`FusedBeamEngine` over a Vamana graph, kernel B1; `flat`: `ExactEngine`'s
two-stage scan), `rate_metric` (the end-to-end metric the window's
queries per second are reported under), `batch`, `batches_per_call`,
`k`, `beam_width` (vamana), `pool_calls` (distinct query groups, cycled
through the window), `sample_queries` (the judged sample),
`profile_after_s` and `profile_s` (the traced run's sub-window).

Configuration (`benchmark/configs/<config>.json`): `n`, `d`, `metric`,
`clusters`, `center_scale` (the corpus, `data/vectors.py:mixture`),
`graph` (`degree`, `build_complexity`, `alpha`, `wave_size`) and
`search` (`expansions`).
"""

from __future__ import annotations

import time
from typing import Dict

from benchmark.data import seeds, vectors
from benchmark.reference import exact, judge


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log, out_dir: str, name: str):
        self.cfg, self.tr, self.seed, self.dev = config, traffic, seed, device
        self.log = log
        self.calls = []            # (group index, ids, scores) on the host
        self.engine = None
        self.ctx: Dict = {}

    # ------------------------------------------------------------ inputs

    def inputs(self) -> None:
        """The corpus and the distinct query groups, from the seed: made
        on the device, kept on the host (the groups pinned)."""
        import torch

        c = self.cfg
        corpus = vectors.mixture(c["n"], c["d"], c["clusters"],
                                 c["center_scale"], self.seed, self.dev)
        m, b = self.tr["batches_per_call"], self.tr["batch"]
        q = vectors.near_rows(corpus, self.tr["pool_calls"] * m * b,
                              self.seed, "queries")
        self.corpus = corpus.cpu()
        groups = q.reshape(self.tr["pool_calls"], m, b, c["d"]).cpu()
        self.groups = groups.pin_memory() if self.dev.type == "cuda" \
            else groups
        del corpus, q

    # ------------------------------------------------------------ program

    def setup(self) -> None:
        c, tr = self.cfg, self.tr
        corpus = self.corpus.numpy()
        if tr["engine"] == "vamana":
            from leann_tpu_torch.ops.fused_beam import FusedBeamEngine
            from leann_tpu_torch.ops.vamana import build_vamana

            g = c["graph"]
            t0 = time.perf_counter()
            adjacency, medoid = build_vamana(
                corpus, graph_degree=g["degree"],
                complexity=g["build_complexity"], alpha=g["alpha"],
                metric=c["metric"], wave_size=g["wave_size"],
                device=self.dev)
            self.log(f"graph built in {time.perf_counter() - t0:.1f} s")
            self.engine = FusedBeamEngine(
                corpus, adjacency, medoid, metric=c["metric"],
                expansions=c["search"]["expansions"], device=self.dev)
            self.kw = {"beam_width": tr["beam_width"]}
        elif tr["engine"] == "flat":
            from leann_tpu_torch.ops.distance import ExactEngine

            self.engine = ExactEngine(corpus, metric=c["metric"],
                                      device=self.dev)
            self.kw = {}
        else:
            raise ValueError(f"unknown engine {tr['engine']!r}")
        for _ in range(2):          # the window's one shape, twice
            self._call(0)
        self.calls.clear()

    def _call(self, i: int):
        g = i % len(self.groups)
        qd = self.groups[g].to(self.dev)
        ids, sc = self.engine.search_many_device(qd, self.tr["k"], **self.kw)
        self.calls.append((g, ids.cpu(), sc.cpu()))

    def launches(self) -> int:
        from leann_tpu_torch.ops.fused_beam import fused_beam_search

        return fused_beam_search.launches

    def window(self, seconds: float, sub=None) -> Dict:
        import torch

        m, b = self.tr["batches_per_call"], self.tr["batch"]
        t_prof = self.tr["profile_after_s"]
        t_end_prof = t_prof + self.tr["profile_s"]
        i = 0
        t0 = time.perf_counter()
        while True:
            self._call(i)
            i += 1
            now = time.perf_counter() - t0
            if sub is not None and not sub.active and now >= t_prof:
                sub.start()
                self.ctx.update(calls0=i, launches0=self.launches())
            elif sub is not None and sub.active and "calls1" not in \
                    self.ctx and now >= t_end_prof:
                sub.stop()
                self.ctx.update(calls1=i, launches1=self.launches())
            if now >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        if sub is not None and sub.active and "calls1" not in self.ctx:
            sub.stop()
            self.ctx.update(calls1=i, launches1=self.launches())
        queries = i * m * b
        self.log(f"window: {i} calls, {queries} queries in {elapsed:.3f} s")
        return {"metrics": {self.tr["rate_metric"]: queries / elapsed},
                "attempted": queries, "failed": 0}

    def context(self, profile) -> Dict:
        """What the per-layer readers read: the profile, the batches and
        B1 launches inside the sub-window, and B1's arguments for the
        batches of one group (the bound's reruns)."""
        ctx = {"profile": profile, "engine": self.tr["engine"]}
        if "calls1" in self.ctx:
            ctx["batches"] = ((self.ctx["calls1"] - self.ctx["calls0"])
                              * self.tr["batches_per_call"])
            ctx["b1_launches"] = (self.ctx["launches1"]
                                  - self.ctx["launches0"])
        if self.tr["engine"] == "vamana":
            import torch

            from leann_tpu_torch.ops.fused_beam import fused_beam_search

            b = self.tr["batch"]
            exc = torch.full((b,), -1, dtype=torch.int32, device=self.dev)
            ctx["b1_calls"] = [
                self.engine.kernel_args(q.to(self.dev), exc,
                                        self.tr["beam_width"])
                for q in self.groups[0]]
            ctx["b1_search"] = fused_beam_search
        return ctx

    def release(self) -> None:
        import torch

        self.engine = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ judge

    def judge(self) -> tuple:
        """(recall_at_10 over every query of the window, the numbers of
        the judged sample and `recall_shortfall`)."""
        recall = self._recall()
        numbers = self._sample_numbers()
        numbers["recall_shortfall"] = 1.0 - recall
        return {"recall_at_10": recall}, numbers

    def _recall(self) -> float:
        """recall@k of every call's answers against the plain
        reference's exact top-k of its group."""
        c, k = self.cfg, self.tr["k"]
        corpus = self.corpus.to(self.dev)
        ref_ids, _ = exact.topk(self.groups.reshape(-1, c["d"]), corpus, k,
                                c["metric"])
        per_group = ref_ids.reshape(len(self.groups), -1, k)
        hit = total = 0
        for g, ids, _ in self.calls:
            hit += judge.hits(ids.reshape(-1, k).to(self.dev), per_group[g])
            total += per_group[g].numel()
        return hit / total

    def _sample_numbers(self) -> Dict[str, float]:
        q, ids, sc = self.sample()
        return judge.batch_numbers(q, ids, sc, self.corpus.to(self.dev),
                                   self.cfg["metric"],
                                   ranked=self.tr["engine"] == "flat")

    def sample(self):
        """The judged sample: `sample_queries` (call, row) pairs of the
        window, drawn from the seed, with the program's answers."""
        import torch

        r = seeds.rng(self.seed, "sample")
        m, b = self.tr["batches_per_call"], self.tr["batch"]
        n = min(self.tr["sample_queries"], len(self.calls) * m * b)
        pick = r.choice(len(self.calls) * m * b, n, replace=False)
        calls, rows = pick // (m * b), pick % (m * b)
        q = torch.stack([self.groups[self.calls[c][0]].reshape(-1,
                         self.cfg["d"])[r_] for c, r_ in zip(calls, rows)])
        ids = torch.stack([self.calls[c][1].reshape(-1, self.tr["k"])[r_]
                           for c, r_ in zip(calls, rows)])
        sc = torch.stack([self.calls[c][2].reshape(-1, self.tr["k"])[r_]
                          for c, r_ in zip(calls, rows)])
        return q, ids, sc

    def control(self, dtype, seconds: float) -> Dict[str, float]:
        """The numbers of the plain reference put in the program's place
        at `dtype`: exact search over the pool's queries at the cell's
        batch, judged on a sample drawn as a run draws it."""
        c, tr = self.cfg, self.tr
        corpus = self.corpus.to(self.dev)
        m, b = tr["batches_per_call"], tr["batch"]
        for g in range(len(self.groups)):
            ids, sc = exact.topk(self.groups[g].reshape(-1, c["d"]), corpus,
                                 tr["k"], c["metric"], dtype=dtype)
            self.calls.append((g, ids.reshape(m, b, -1).cpu(),
                               sc.float().reshape(m, b, -1).cpu()))
        numbers = self._sample_numbers()
        numbers["recall_shortfall"] = 1.0 - self._recall()
        return numbers
