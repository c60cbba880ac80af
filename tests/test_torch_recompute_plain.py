"""Pruned recompute in the port (`models/bert.py:bert_forward`,
`ops/beam.py:RecomputeBeamEngine`, `index/recompute.py:
GraphRecomputeSearcher`) against the plain encoder and brute force of
`tests/plain_recompute.py`, which imports neither package, on the CPU.

Tolerances, each with its reason:
  - `bert_forward` against the plain forward on the same weights and
    tokens: float32 within 1e-6 a component (the two sum in other
    orders: ~1e-7 measured); bf16 products within 3e-4 a component and
    1 - cosine within 1e-6: where the float32 input of a bf16 rounding
    differs in its last bits between the two sum orders, it rounds to
    the neighbouring bf16 value (2^-8 apart), which moves a few
    components by up to ~1e-4 at 768 wide (7.8e-5 measured) and leaves
    the direction all but unmoved (2.4e-7 measured);
  - returned scores against the plain <q, e(id)>: 1e-6 with float32
    products; 1e-4 with bf16 products at the tiny widths, where one such
    neighbouring rounding moves a 64-wide embedding by ~1e-5;
  - recall@10 against the plain exact top-10 at least 0.9 at beam 32,
    and each query's own passage first.
Dedup on and off encode the same rows in other batches and must give
the same bits on the CPU; `search` returns row 0 of `search_many` of its
one query, and `Index.search` on the pruned index is
`GraphRecomputeSearcher.search`.
The benchmark's plain reference (`benchmark/reference/recompute.py`)
agrees with this one, and its bf16 control does not.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import plain_recompute as plain
from leann_tpu_torch.embed import LocalEmbedding
from leann_tpu_torch.index import GraphRecomputeSearcher, StreamingIndexBuilder
from leann_tpu_torch.models import bert
from leann_tpu_torch.store.embeddings import embeddings_path, prune_embeddings
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import Passage

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2000
FORBIDDEN = {"jax", "jaxlib", "flax", "leann_tpu", "leann_tpu_torch"}


def texts(n, start=0):
    return [f"passage {i} about subject {i % 911} topic {i % 101} "
            f"facet {i % 37} keyword{i % 7} detail {i}"
            for i in range(start, start + n)]


@pytest.mark.parametrize("widths", ["tiny", "768x2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_forward_matches_plain(widths, dtype):
    base = (bert.BertConfig.tiny() if widths == "tiny"
            else bert.BertConfig(num_layers=2))
    cfg = bert.BertConfig(**dict(base.__dict__, compute_dtype=dtype))
    enc = bert.BertEncoder(cfg, max_length=48, seed=3, device="cpu")
    rows = [t + " w" * (i % 5) for i, t in enumerate(texts(12, 990))]
    tok, mask = enc.tokenize_corpus(rows, max_length=48)
    with torch.no_grad():
        got = bert.bert_forward(enc.params, torch.from_numpy(tok),
                                torch.from_numpy(mask), cfg)
    want = plain.encode(bert.init_params(cfg, 3), tok, mask, cfg.num_heads,
                        bf16=dtype == "bfloat16")
    gap = float((got - want).abs().max())
    cos = float((1 - (got * want).sum(1)).abs().max())
    if dtype == "float32":
        assert gap <= 1e-6, gap
    else:
        assert gap <= 3e-4 and cos <= 1e-6, (gap, cos)


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    """A pruned 2,000-passage index built as the CLI builds a local-tiny
    one: hnsw -> vamana, ip, the token sidecar, vectors deleted."""
    base = str(tmp_path_factory.mktemp("pruned") / "indexes" / "p"
               / "documents.leann")
    emb = LocalEmbedding(device="cpu")
    rows = texts(N)
    builder = StreamingIndexBuilder(
        base, dim=emb.dimensions, backend="hnsw", metric="ip",
        embedding_model="local-tiny", embedding_mode="local",
        is_recompute=True, tokenizer_encoder=emb.encoder, device="cpu")
    builder.add_batch([Passage(id=f"p{i}", text=t, metadata={"facet": i % 37})
                       for i, t in enumerate(rows)], emb.embed(rows))
    builder.build(graph_degree=16, complexity=32)
    prune_embeddings(base)
    meta = IndexMeta.load(meta_path(base))
    meta.is_pruned = True
    meta.save(meta_path(base))
    assert not os.path.exists(embeddings_path(base))
    q_rows = np.random.default_rng(26).choice(N, 24, replace=False)
    return base, emb.encoder, rows, q_rows


def _plain_side(enc, rows, q_rows, bf16):
    """The plain embeddings of every passage (from its own tokens) and
    of the query texts, and their exact top-10."""
    params = bert.init_params(enc.config, 0)
    tok, mask = enc.tokenize_corpus(rows)
    corpus = plain.encode(params, tok, mask, enc.config.num_heads, bf16=bf16)
    qt, qm = enc.tokenizer.encode_batch([rows[i] for i in q_rows])
    queries = plain.encode(params, qt, qm, enc.config.num_heads, bf16=bf16)
    return corpus, queries, plain.brute_force(queries, corpus, 10)[0]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-4)])
def test_search_many_matches_plain_brute_force(pruned, dtype, tol):
    base, enc, rows, q_rows = pruned
    if dtype != enc.config.compute_dtype:
        enc = bert.BertEncoder(bert.BertConfig.tiny(), compute_dtype=dtype,
                               device="cpu")
    searcher = GraphRecomputeSearcher(base, enc, device="cpu")
    q = enc.embed([rows[i] for i in q_rows])
    ids, scores = searcher.search_many(q, top_k=10, complexity=32)
    assert ids.shape == scores.shape == (len(q_rows), 10)
    corpus, queries, top = _plain_side(enc, rows, q_rows,
                                       dtype == "bfloat16")
    assert (ids >= 0).all() and (ids < N).all()
    assert all(len(set(r.tolist())) == 10 for r in ids)
    assert (np.diff(scores, axis=1) <= 0).all()
    want = torch.einsum("bkd,bd->bk", corpus[torch.from_numpy(ids)].double(),
                        queries.double())
    gap = float((torch.from_numpy(scores).double() - want).abs().max())
    assert gap <= tol, gap
    recall = float((torch.from_numpy(ids)[:, :, None] == top[:, None, :])
                   .any(1).float().mean())
    assert recall >= 0.9, recall
    assert ids[:, 0].tolist() == q_rows.tolist()


def test_dedup_on_and_off_are_bit_equal(pruned):
    base, enc, rows, q_rows = pruned
    engine = GraphRecomputeSearcher(base, enc, device="cpu").engine
    q = enc.embed([rows[i] for i in q_rows])
    on = engine.search(q, k=10, beam_width=32, dedup=True)
    hits = dict(engine.last_stats)
    off = engine.search(q, k=10, beam_width=32, dedup=False)
    assert hits["misses"] < engine.last_stats["encoded_rows"]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_search_is_row_zero_of_search_many(pruned):
    from leann_tpu_torch.api import Index

    base, enc, rows, q_rows = pruned
    searcher = GraphRecomputeSearcher(base, enc, device="cpu")
    q = enc.embed([rows[i] for i in q_rows[:3]])
    ids, scores = searcher.search_many(q, top_k=5, complexity=32)
    one_ids, one_scores = searcher.search_many(q[0], top_k=5, complexity=32)
    # alone, the query's products sum in another blocking: same ids,
    # scores within float32 rounding
    np.testing.assert_array_equal(one_ids[0], ids[0])
    np.testing.assert_allclose(one_scores[0], scores[0], rtol=0, atol=1e-6)
    hits = searcher.search(q[0], top_k=5, complexity=32)
    assert [h.id for h in hits] == [f"p{i}" for i in one_ids[0]]
    assert [h.score for h in hits] == one_scores[0].tolist()
    idx = Index(base, device="cpu")
    assert idx.is_pruned
    assert isinstance(idx._recompute_searcher(), GraphRecomputeSearcher)
    got = idx.search(rows[q_rows[0]], top_k=5, complexity=32, hybrid=False,
                     expand=False)
    assert [h.id for h in got] == [h.id for h in hits]


@pytest.mark.parametrize("widths", ["tiny", "768x2"])
def test_the_benchmark_reference_agrees_and_its_control_does_not(widths):
    from benchmark.reference import recompute as ref

    base = (bert.BertConfig.tiny() if widths == "tiny"
            else bert.BertConfig(num_layers=2))
    enc = {k: getattr(base, k) for k in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_position_embeddings", "type_vocab_size",
        "layer_norm_eps")}
    rows = [t + " w" * (i % 5) for i, t in enumerate(texts(10, 40))]
    w = ref.init_weights(enc, 4, "cpu")
    got = ref.embed(w, enc, rows, 48, "cpu", rows=4)
    low = ref.embed(w, enc, rows, 48, "cpu", low="bf16")
    fp8 = ref.embed(w, enc, rows, 48, "cpu", low="fp8")
    tok = bert.HashTokenizer(base.vocab_size, 48)
    ids, mask = tok.encode_batch(rows)
    want = plain.encode(bert.init_params(base, 4), ids, mask, base.num_heads)
    assert float((got - want).abs().max()) <= 3e-4
    assert float((1 - (got * want).sum(1)).abs().max()) <= 1e-6
    # the controls move every row by far more: bf16 results, and the fp8
    # operands by more again
    assert float((low - want).abs().max(1).values.min()) > 1e-4
    assert float((fp8 - want).abs().max(1).values.min()) > 1e-3


def test_the_references_import_nothing_of_either_package():
    code = """
import json, sys
sys.path.insert(0, "tests")
import torch
import plain_recompute
import benchmark.reference.recompute as ref
b = torch.backends
flags = []
for off in (ref.no_tf32, plain_recompute.no_tf32):
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    off()
    flags += [b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32]
print(json.dumps([sorted({m.split(".")[0] for m in sys.modules}), flags]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top, flags = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(top) & FORBIDDEN, set(top) & FORBIDDEN
    assert flags == [False] * 4
