"""Parity of the port's pruned recompute (`leann_tpu_torch/ops/beam.py`:
the carried-state core, `beam_search_recompute_batch` /
`_segmented`, the dedup cache, `RecomputeBeamEngine`;
`index/recompute.py`; `store/tokens.py`; the builder's token sidecar)
with the JAX reference, on the CPU.

The setup is `tests/test_recompute_paths.py`'s: `BertConfig.tiny()`,
240 texts tokenized at 16, the reference's Vamana graph (R=12, L=24),
queries at rows 5, 50, 150 and 230; the port gets the same tokens,
adjacency and medoid, and the reference's weights carried across.

Tolerances: ids equal; scores within 1e-4 against the reference (both
encoders round each product's operands to bf16 and keep float32 sums,
in another order), and within the port exactly where only the
traversal's bookkeeping differs (segments), within 1e-5 where the same
rows are encoded in other batches (the cache)."""

import os

import numpy as np
import pytest
import torch

from leann_tpu.index.recompute import (
    GraphRecomputeSearcher as JGraphRecomputeSearcher,
    RecomputeSearcher as JRecomputeSearcher,
)
from leann_tpu.models.bert import BertConfig as JBertConfig
from leann_tpu.models.bert import BertEncoder as JBertEncoder
from leann_tpu.ops.beam import RecomputeBeamEngine as JRecomputeBeamEngine
from leann_tpu.ops.vamana import build_vamana
from leann_tpu.store import tokens as jtokens
from leann_tpu_torch.embed import LocalEmbedding
from leann_tpu_torch.index import (
    GraphRecomputeSearcher,
    MetadataFilter,
    RecomputeSearcher,
    StreamingIndexBuilder,
)
from leann_tpu_torch.models.bert import BertConfig, BertEncoder, params_from_reference
from leann_tpu_torch.ops import beam as tb
from leann_tpu_torch.store import tokens as ttokens
from leann_tpu_torch.store.embeddings import embeddings_path, prune_embeddings
from leann_tpu_torch.store.meta import IndexMeta, meta_path
from leann_tpu_torch.store.passages import Passage

torch.set_num_threads(1)

QUERY_ROWS = [5, 50, 150, 230]


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """An empty jit cache for this module's compiles: at suite scale the
    XLA CPU compiler segfaults with hundreds of live executables (see
    `tests/test_recompute_paths.py`)."""
    import jax

    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    jenc = JBertEncoder(config=JBertConfig.tiny())
    texts = [f"document {i} topic {i % 13} flavor {i % 7}" for i in range(240)]
    vectors = jenc.embed(texts)
    tok, mask = jenc.tokenize_corpus(texts, max_length=16)
    adjacency, medoid = build_vamana(
        vectors, graph_degree=12, complexity=24, metric="ip", wave_size=64
    )
    tenc = BertEncoder(config=BertConfig.tiny(), device="cpu")
    tenc.params = params_from_reference(jenc.params, device="cpu")
    return dict(jenc=jenc, tenc=tenc, texts=texts, vectors=vectors, tok=tok,
                mask=mask, adjacency=np.asarray(adjacency),
                medoid=int(medoid), queries=vectors[QUERY_ROWS])


def _modes(monkeypatch, dedup, segment, chunk):
    """Sets the reference's knobs for a mode and returns the port's
    arguments for it."""
    monkeypatch.setenv("LEANN_RECOMPUTE_DEDUP", "1" if dedup else "0")
    monkeypatch.setenv("LEANN_RECOMPUTE_SEGMENT", str(segment))
    if chunk is None:
        monkeypatch.delenv("LEANN_RECOMPUTE_ENC_CHUNK", raising=False)
    else:
        monkeypatch.setenv("LEANN_RECOMPUTE_ENC_CHUNK", str(chunk))
    return dict(dedup=dedup, segment_iters=segment,
                enc_chunk=tb.ENC_CHUNK if chunk is None else chunk)


def _port_engine(s, seeds=1024):
    return tb.RecomputeBeamEngine(s["tok"], s["mask"], s["adjacency"],
                                  s["medoid"], s["tenc"], metric="ip",
                                  seed_pool=seeds, device="cpu")


@pytest.mark.parametrize("dedup,segment,chunk,seeds", [
    (False, 0, None, None), (True, 0, None, None), (False, 4, None, None),
    (True, 4, None, None), (True, 0, 96, None), (False, 0, None, 32),
    (True, 0, 96, 32), (True, 0, 16, 32), (True, 4, None, 32),
])
def test_engine_matches_reference(setup, monkeypatch, dedup, segment, chunk,
                                  seeds):
    """Each mode against the reference in the same mode: dedup off / on,
    one pass / segments of 4 hops, encoder chunks of 96 and 16. The
    default seed pool (1024) holds all 240 nodes, so the cache never
    misses; with a pool of 32 the traversal encodes up to 27 misses a hop
    (4 queries x R=12 slots): chunks of 96 take the small-chunk loop
    (c_small 16) only, chunks of 16 both loops."""
    s = setup
    modes = _modes(monkeypatch, dedup, segment, chunk)
    if seeds is not None:
        monkeypatch.setenv("LEANN_RECOMPUTE_SEEDS", str(seeds))
    jeng = JRecomputeBeamEngine(s["tok"], s["mask"], s["adjacency"],
                                s["medoid"], s["jenc"], metric="ip")
    want_ids, want_sc = jeng.search(s["queries"], k=5, beam_width=24)
    eng = _port_engine(s, 1024 if seeds is None else seeds)
    ids, sc = eng.search(s["queries"], k=5, beam_width=24, **modes)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=1e-4)
    assert ids[:, 0].tolist() == QUERY_ROWS
    stats = eng.last_stats
    assert stats["hops"] > 0 and stats["slots"] == stats["hops"] * 4 * 12
    if not dedup:
        assert "misses" not in stats
        assert stats["encoded_rows"] == stats["slots"]
    elif seeds is None:
        assert stats["misses"] == stats["encoded_rows"] == 0
    else:
        assert 0 < stats["misses"] <= stats["encoded_rows"]
        assert stats["misses"] < stats["slots"]


def test_port_modes_agree_and_seed_pool_matches(setup, monkeypatch):
    """Within the port: segments equal one pass exactly, the cache and
    the plain path's chunked forwards (`chunk`) equal the plain path
    (1e-5), and the seed pool (ids, shape) equals the reference's."""
    s = setup
    port_engine = _port_engine(s, seeds=32)
    out = {}
    for dedup in (False, True):
        for segment in (0, 3):
            out[dedup, segment] = port_engine.search(
                s["queries"], k=8, beam_width=16, dedup=dedup,
                segment_iters=segment)
    # the plain path's forwards split into chunks of 10 rows: 48 slots a
    # hop pad to 5 x 10
    e = port_engine
    stats = {}
    ids, sc = tb.beam_search_recompute_batch(
        torch.from_numpy(s["queries"]), e.token_ids, e.attn_mask,
        e.adjacency, e.encoder.params, e.medoid,
        torch.full((4,), -1, dtype=torch.int64), beam_width=16,
        max_iters=2 * 16 + 16, metric="ip", config=e.encoder.config,
        hash_bits=e.hash_bits, visited_pool=e.visited_pool,
        seed_ids=e.seed_ids, seed_vecs=e.seed_vecs, n_entries=8, chunk=10,
        stats=stats)
    ids = ids[:, :8].numpy()
    out["chunked"] = np.where(ids == 240, -1, ids), sc[:, :8].numpy()
    assert stats["encoded_rows"] == stats["hops"] * 50
    np.testing.assert_array_equal(out["chunked"][0], out[False, 0][0])
    np.testing.assert_allclose(out["chunked"][1], out[False, 0][1], rtol=0,
                               atol=1e-5)
    for dedup in (False, True):
        for a, b in zip(out[dedup, 0], out[dedup, 3]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[True, 0][0], out[False, 0][0])
    np.testing.assert_allclose(out[True, 0][1], out[False, 0][1], rtol=0,
                               atol=1e-5)

    monkeypatch.setenv("LEANN_RECOMPUTE_SEEDS", "32")
    jeng = JRecomputeBeamEngine(s["tok"], s["mask"], s["adjacency"],
                                s["medoid"], s["jenc"], metric="ip")
    assert len(jeng.seed_ids) < 240
    np.testing.assert_array_equal(port_engine.seed_ids.numpy(),
                                  np.asarray(jeng.seed_ids))
    assert tuple(port_engine.seed_vecs.shape) == tuple(jeng.seed_vecs.shape)
    np.testing.assert_allclose(port_engine.seed_vecs.numpy(),
                               np.asarray(jeng.seed_vecs), rtol=0, atol=2e-3)


def test_stateless_core_resumes_to_the_same_state(setup):
    """The carried state of `_beam_search_core` on a stored-vector
    expand: segments of 2 hops, resumed, end in the one-pass beam and
    visited log; the stateful form with an aux counter sees every hop."""
    s = setup
    vecs = torch.from_numpy(np.concatenate(
        [s["vectors"], np.zeros((1, s["vectors"].shape[1]), np.float32)]))
    adj = torch.from_numpy(np.concatenate(
        [s["adjacency"], np.full((1, 12), 240, np.int32)]).astype(np.int64))
    q = torch.from_numpy(s["queries"])
    exc = torch.full((4,), -1, dtype=torch.int64)

    def score_fn(qq, ids):
        return torch.einsum("bkd,bd->bk", vecs[ids], qq)

    def expand_fn(qq, u):
        nbrs = adj[u].reshape(qq.shape[0], -1)
        return nbrs, score_fn(qq, nbrs)

    def counted(qq, u, aux):
        return (*expand_fn(qq, u), aux + 1)

    args = (q, 12, s["medoid"], exc)
    kw = dict(n_sentinel=240, beam_width=16, max_iters=40, track_visited=32)
    want = tb._beam_search_core(*args, expand_fn, score_fn, **kw)
    state = None
    while state is None or not tb._recompute_done(state, 40, 240):
        state = tb._beam_search_core(
            *args, counted, score_fn, **kw, iter_budget=2, init_state=state,
            aux_init=0, stateful_expand=True)
    got = (state[0], state[1], state[5], state[6])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert state[7] == state[4] > 2


def test_tokens_sidecar_round_trip_and_cross_load(setup, tmp_path):
    s = setup
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ttokens.save_tokens(ours, s["tok"], s["mask"])
    jtokens.save_tokens(theirs, s["tok"], s["mask"])
    assert ttokens.tokens_exist(ours) and not ttokens.tokens_exist(
        str(tmp_path / "none"))
    for load in (ttokens.load_tokens, jtokens.load_tokens):
        for base in (ours, theirs):
            tok, mask = load(base)
            assert tok.dtype == np.int32 and mask.dtype == np.int32
            np.testing.assert_array_equal(tok, s["tok"])
            np.testing.assert_array_equal(mask, s["mask"])
    with np.load(ttokens.tokens_path(ours)) as z:
        assert sorted(z.files) == ["lengths", "token_ids"]
        assert z["lengths"].dtype == np.int32


class _Provider:
    """A provider double: `embed_with_template` over an encoder's embed
    (no template)."""

    def __init__(self, embed):
        self.embed = embed

    def embed_with_template(self, texts, template):
        assert template is None
        return self.embed(texts)


def test_pruned_index_end_to_end(setup, tmp_path):
    """Build with is_recompute (token sidecar), prune, then both graph
    searchers on the same files and both brute-force searchers with a
    filter: the passage's own id first, ids equal to the reference's,
    scores within 1e-4."""
    s = setup
    base = str(tmp_path / "idx" / "documents.leann")
    vecs = LocalEmbedding(encoder=s["tenc"]).embed(s["texts"])
    builder = StreamingIndexBuilder(
        base, dim=64, backend="hnsw", metric="ip", embedding_mode="local",
        is_recompute=True, tokenizer_encoder=s["tenc"], device="cpu")
    for i, (t, v) in enumerate(zip(s["texts"], vecs)):
        builder.add_passage(Passage(id=f"p{i}", text=t,
                                    metadata={"facet": i % 7}), v)
    builder.build(graph_degree=12, complexity=24)
    tok, mask = ttokens.load_tokens(base)
    want_tok, want_mask = s["tenc"].tokenize_corpus(s["texts"])
    np.testing.assert_array_equal(tok, want_tok)
    np.testing.assert_array_equal(mask, want_mask)

    assert prune_embeddings(base) > 0 and prune_embeddings(base) is None
    meta = IndexMeta.load(meta_path(base))
    assert meta.is_recompute
    meta.is_pruned = True
    meta.save(meta_path(base))

    ours = GraphRecomputeSearcher(base, s["tenc"], device="cpu")
    theirs = JGraphRecomputeSearcher(base, s["jenc"])
    for row in QUERY_ROWS:
        got = ours.search(vecs[row], top_k=5, complexity=24)
        want = theirs.search(vecs[row], top_k=5, complexity=24)
        assert got[0].id == f"p{row}"
        assert [r.id for r in got] == [r.id for r in want]
        np.testing.assert_allclose([r.score for r in got],
                                   [r.score for r in want], rtol=0, atol=1e-4)

    filt = MetadataFilter.parse("facet=3")
    ours = RecomputeSearcher(base, _Provider(
        LocalEmbedding(encoder=s["tenc"]).embed), device="cpu")
    theirs = JRecomputeSearcher(base, _Provider(s["jenc"].embed))
    got = ours.search(vecs[10], top_k=5, filter=filt)
    want = theirs.search(vecs[10], top_k=5, filter=filt)
    assert got[0].id == "p10" and all(r.metadata["facet"] == 3 for r in got)
    assert [r.id for r in got] == [r.id for r in want]
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0, atol=1e-4)
    assert not os.path.exists(embeddings_path(base))
