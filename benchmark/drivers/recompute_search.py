"""Batch search on a pruned index by recompute (BASELINE config 3): no
stored vectors; each search re-embeds the passages its traversal visits
from their stored tokens with the encoder on the device.

Set-up builds the index as a deployment does: the encoder
(`models.bert.BertEncoder`, the configuration's widths, weights from its
seed) embeds the corpus through `LocalEmbedding`,
`StreamingIndexBuilder(is_recompute=True)` writes passages, vectors,
the graph (hnsw -> vamana) and the token sidecar, then
`prune_embeddings` deletes the vectors and the meta is marked pruned.
The searcher is the one `api.Index` opens for a pruned local index with
a graph and tokens: `GraphRecomputeSearcher(base, encoder)`. A call
embeds its query texts with the index's encoder, as `Index.embed` does
(`LocalEmbedding`'s batch of 128; the meta gives no query template),
then searches them with `GraphRecomputeSearcher.search_many`; the ids
and scores come back to the host. The window and its profiled
sub-window are `batch_search`'s, one batch a call.

Traffic parameters (`benchmark/traffic/<mix>.json`): `rate_metric`,
`batch` (query texts a call), `batches_per_call` (1), `k`,
`pool_calls` (distinct query groups, cycled), `profile_after_s` and
`profile_s`.

Configuration: `n` passages of the template `passage_text` at
`source_n` template rows drawn from the seed, metadata `facet` (the
row mod `facets`); `metric`; `encoder` (the widths, `compute_dtype`,
`weights_seed`); `tokens.max_length`; `build` (`backend`,
`graph_degree`, `complexity`, `alpha`; `passes`, `build_vamana`'s default);
`search` (`beam_width`; `dedup`, the search's default, and the build's
`passes`, `build_vamana`'s: set-up stops where the program's differ).
The engine's own tuning (seed pool, visited pool, encoder chunk,
segments) is the program's and is not fixed here.

The judged numbers, against the plain reference
(`benchmark/reference/recompute.py`: its own tokenizer, weights from the
same seed, BERT at the stated arithmetic), over every call of the window:
  bad_rows          rows with an id out of range or twice, a score not
                    finite, or scores out of order
  score_gap_mean    the mean over every returned (query, id) of the gap
                    between its score and the float64 product of the
                    reference's embeddings of the query and of the id's
                    passage, over |q||e|
  score_err         the widest such gap, logged: at 12 bf16 layers two
                    sound sum orders part where a bf16 rounding falls the
                    other way, and the widest gap of a sound run is as
                    wide as the bf16-output control's, while their means
                    stand apart
  recall_shortfall  1 - recall@k against the exact top-k over the
                    reference's embeddings of every passage
A program without `GraphRecomputeSearcher.search_many` or the engine's
traced counters cannot run the cell: it stops before its inputs are made.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark.data import seeds
from benchmark.drivers import batch_search
from benchmark.reference import exact, judge
from benchmark.reference import recompute as ref

COUNTERS = ("encoded_rows", "misses", "hops", "traced_queries")


def passage_text(i: int) -> str:
    """Template row `i` (`evals/recompute_scale.py:76-80`)."""
    return (f"passage {i} about subject {i % 911} topic {i % 101} "
            f"facet {i % 37} keyword{i % 7} detail {i}")


def _engine_class():
    from leann_tpu_torch.ops.beam import RecomputeBeamEngine

    return RecomputeBeamEngine


def _counts() -> Dict[str, int]:
    engine = _engine_class()
    return {name: int(getattr(engine, name)) for name in COUNTERS}


class Cell(batch_search.Cell):

    def __init__(self, config, traffic, seed, device, log, out_dir, name):
        super().__init__(config, traffic, seed, device, log, out_dir, name)
        self.out_dir = out_dir
        self.tmp = None
        self.searcher = None
        self.template = ""          # the meta's query template, at set-up

    def inputs(self) -> None:
        """The passages and the query groups, from the seed: `n` template
        rows of `source_n` and `pool_calls` groups of `batch` passages'
        texts, drawn without repeats."""
        from leann_tpu_torch.index.recompute import GraphRecomputeSearcher

        engine = _engine_class()
        lacking = ([] if hasattr(GraphRecomputeSearcher, "search_many")
                   else ["GraphRecomputeSearcher.search_many"])
        lacking += [f"RecomputeBeamEngine.{c}" for c in COUNTERS
                    if not hasattr(engine, c)]
        if lacking:
            raise RuntimeError(f"the program lacks {', '.join(lacking)}: "
                               "the recompute cell cannot run")
        c, tr = self.cfg, self.tr
        rows = np.sort(seeds.rng(self.seed, "corpus").choice(
            c["source_n"], c["n"], replace=False))
        self.rows = rows
        self.texts = [passage_text(int(j)) for j in rows]
        picks = seeds.rng(self.seed, "queries").choice(
            c["n"], tr["pool_calls"] * tr["batch"], replace=False)
        self.query_rows = picks.reshape(tr["pool_calls"], tr["batch"])
        self.groups = [[self.texts[i] for i in g] for g in self.query_rows]

    # ------------------------------------------------------------ program

    def widths(self) -> Dict:
        """The configuration's `encoder` under `BertConfig`'s names."""
        enc = dict(self.cfg["encoder"])
        enc["num_layers"] = enc.pop("num_hidden_layers")
        enc["num_heads"] = enc.pop("num_attention_heads")
        return enc

    def _check_defaults(self) -> None:
        """The deployment settings the configuration states and the
        program takes by default: the search's dedup cache and the
        build's passes."""
        import inspect

        from leann_tpu_torch.ops.beam import RecomputeBeamEngine
        from leann_tpu_torch.ops.vamana import build_vamana

        def default(fn, name):
            return inspect.signature(fn).parameters[name].default

        got = {"dedup": default(RecomputeBeamEngine.search, "dedup"),
               "passes": default(build_vamana, "passes")}
        want = {"dedup": self.cfg["search"]["dedup"],
                "passes": self.cfg["build"]["passes"]}
        differ = {k: (v, got.get(k)) for k, v in want.items()
                  if got.get(k) != v}
        if differ:
            raise RuntimeError("the program's defaults are not the "
                               f"configuration's: {differ}")

    def setup(self) -> None:
        from leann_tpu_torch.cli.common import resolve_query_template
        from leann_tpu_torch.embed.local import LocalEmbedding
        from leann_tpu_torch.index.builder import StreamingIndexBuilder
        from leann_tpu_torch.index.recompute import GraphRecomputeSearcher
        from leann_tpu_torch.models.bert import BertEncoder
        from leann_tpu_torch.store.embeddings import (embeddings_path,
                                                      prune_embeddings)
        from leann_tpu_torch.store.meta import IndexMeta, meta_path
        from leann_tpu_torch.store.passages import Passage

        from leann_tpu_torch.models.bert import BertConfig

        c, b = self.cfg, self.cfg["build"]
        self._check_defaults()
        widths = self.widths()
        seed = widths.pop("weights_seed")
        os.makedirs(self.out_dir, exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="recompute-", dir=self.out_dir)
        base = os.path.join(self.tmp, "documents.leann")
        t0 = time.perf_counter()
        enc = BertEncoder(BertConfig(**widths),
                          max_length=c["tokens"]["max_length"], seed=seed,
                          device=self.dev)
        vecs = LocalEmbedding(encoder=enc, batch_size=512).embed(self.texts)
        t1 = time.perf_counter()
        builder = StreamingIndexBuilder(
            base, dim=enc.dimensions, backend=b["backend"],
            metric=c["metric"], embedding_model=c["embedding_model"],
            embedding_mode="local", is_recompute=True,
            tokenizer_encoder=enc, device=self.dev)
        builder.add_batch(
            [Passage(id=f"p{i}", text=t,
                     metadata={"facet": int(j) % c["facets"]})
             for i, (t, j) in enumerate(zip(self.texts, self.rows))], vecs)
        del vecs
        builder.build(graph_degree=b["graph_degree"],
                      complexity=b["complexity"], alpha=b["alpha"])
        t2 = time.perf_counter()
        prune_embeddings(base)
        meta = IndexMeta.load(meta_path(base))
        meta.is_pruned = True
        meta.save(meta_path(base))
        if os.path.exists(embeddings_path(base)):
            raise RuntimeError("the pruned index still holds its vectors")
        self.searcher = GraphRecomputeSearcher(base, enc, device=self.dev)
        self.template = resolve_query_template(None, meta) or ""
        self.provider = LocalEmbedding(encoder=enc)
        self.log(f"corpus embedded in {t1 - t0:.1f} s, index built in "
                 f"{t2 - t1:.1f} s, pruned; seed pool "
                 f"{self.searcher.engine.seed_ids.numel()}")
        self._call(0)               # the window's shapes, once
        self.calls.clear()
        self.counts0 = _counts()

    def _call(self, i: int):
        import torch

        g = i % len(self.groups)
        texts = [self.template + t for t in self.groups[g]]
        q = np.asarray(self.provider.embed(texts), dtype=np.float32)
        ids, sc = self.searcher.search_many(
            q, top_k=self.tr["k"], complexity=self.cfg["search"]["beam_width"])
        self.calls.append((g, torch.from_numpy(ids), torch.from_numpy(sc)))

    def launches(self) -> int:
        """The recompute search launches no hand-written kernel."""
        return 0

    def context(self, profile) -> Dict:
        """What the per-layer readers read: the profile, the batches
        inside the sub-window, the engine's traced counters since set-up
        (tracing is on only in the sub-window) and the encoder's widths
        at the stored token width."""
        enc = self.cfg["encoder"]
        ctx = {"profile": profile, "engine": "recompute",
               "recompute_counts": {k: v - self.counts0[k]
                                    for k, v in _counts().items()},
               "encoder": {"layers": enc["num_hidden_layers"],
                           "hidden": enc["hidden_size"],
                           "intermediate": enc["intermediate_size"],
                           "t": self.cfg["tokens"]["max_length"]}}
        if "calls1" in self.ctx:
            ctx["batches"] = ((self.ctx["calls1"] - self.ctx["calls0"])
                              * self.tr["batches_per_call"])
        return ctx

    def release(self) -> None:
        self.searcher = self.provider = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
        super().release()

    # ------------------------------------------------------------ judge

    def _reference(self, low=None):
        """The reference's embeddings of every passage [n, H] and of each
        group's queries [G, B, H], on the device; `low` a control of
        `reference.recompute`."""
        enc = self.widths()
        t = self.cfg["tokens"]["max_length"]
        w = ref.init_weights(enc, enc["weights_seed"], self.dev)
        corpus = ref.embed(w, enc, self.texts, t, self.dev, low)
        queries: List[str] = [self.template + s for g in self.groups
                              for s in g]
        q = ref.embed(w, enc, queries, t, self.dev, low)
        return corpus, q.reshape(len(self.groups), self.tr["batch"], -1)

    def judge(self) -> tuple:
        t0 = time.perf_counter()
        corpus, queries = self._reference()
        self.log(f"the reference embedded {corpus.shape[0]} passages and "
                 f"{queries.shape[0] * queries.shape[1]} queries in "
                 f"{time.perf_counter() - t0:.1f} s")
        recall, numbers = self._numbers(corpus, queries)
        return {"recall_at_10": recall}, numbers

    def _numbers(self, corpus, queries):
        """(recall@k of every call, the judged numbers) of `self.calls`
        against the reference's embeddings."""
        import torch

        k, metric, n = self.tr["k"], self.cfg["metric"], corpus.shape[0]
        top = [exact.topk(q, corpus, k, metric)[0] for q in queries]
        hit = total = bad = pairs = 0
        err = gap_sum = 0.0
        for g, ids, sc in self.calls:
            hit += judge.hits(ids.to(self.dev), top[g])
            total += top[g].numel()
            got = judge.batch_numbers(queries[g], ids, sc, corpus, metric,
                                      ranked=False)
            bad += got["bad_rows"]
            err = max(err, got["score_err"])
            live = ((ids >= 0) & (ids < n)).to(self.dev)
            want, scale = exact.scores_of(queries[g], corpus,
                                          ids.clamp(0, n - 1), metric)
            gap = (sc.to(self.dev).double() - want).abs() / scale
            gap_sum += float(torch.where(live, gap, 0.0).sum())
            pairs += int(live.sum())
        recall = hit / total
        return recall, {"bad_rows": float(bad), "score_err": err,
                        "score_gap_mean": gap_sum / max(pairs, 1),
                        "recall_shortfall": 1.0 - recall}

    def control(self, dtype, seconds: float) -> Dict[str, float]:
        """The reference one precision lower in the program's place: the
        passages and queries embedded by a control of
        `reference.recompute` (float8 e4m3: the stated bf16 operands at
        fp8, the next precision below; bfloat16: every product's operands
        and result rounded to bf16), exact top-k of each group over
        those, judged against the sound reference."""
        import torch

        low = {torch.float8_e4m3fn: "fp8", torch.bfloat16: "bf16"}.get(dtype)
        if low is None:
            raise ValueError("the recompute controls are float8_e4m3fn "
                             "and bfloat16")
        corpus, queries = self._reference()
        low_c, low_q = self._reference(low)
        for g in range(len(self.groups)):
            ids, sc = exact.topk(low_q[g], low_c, self.tr["k"],
                                 self.cfg["metric"])
            self.calls.append((g, ids.cpu(), sc.cpu()))
        del low_c, low_q
        return self._numbers(corpus, queries)[1]
