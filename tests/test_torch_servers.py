"""The port's HTTP API and MCP servers (`leann_tpu_torch/server/`) and
`serve`'s pruned adapter, mirroring every case of tests/test_servers.py
on the port on the CPU (the indexes, searchers and MCP server opened
with `device="cpu"`): real sockets, real JSON-RPC framing, the
micro-batcher's coalescing, grouping, error propagation and depth-2
flush pipeline, and `ServerState.warm`'s pow-2 lattice. Then cases of
the port's own: the JSON bodies and MCP replies equal the reference
server's on the same index, and the launch counters stay exact under
concurrent increments.
"""

import io
import json
import threading
import urllib.request

import pytest

from leann_tpu_torch.embed import EmbeddingProvider
from leann_tpu_torch.index.builder import IndexBuilder
from leann_tpu_torch.index.searcher import IndexSearcher
from leann_tpu_torch.server.http import ServerState, serve
from leann_tpu_torch.server.mcp import McpServer


@pytest.fixture()
def http_server(tmp_index_base):
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [
        "the quick brown fox",
        "tensor processing units and the MXU",
        "bm25 ranking function",
    ]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    searcher = IndexSearcher.load(tmp_index_base, device="cpu")
    state = ServerState(searcher, provider, None, "testidx")
    server = serve(state, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    state.batcher.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(http_server):
    status, body = _get(http_server + "/health")
    assert status == 200 and body["status"] == "ok"


def test_root_and_info(http_server):
    status, body = _get(http_server + "/")
    assert status == 200 and body["service"] == "leann-tpu"
    status, body = _get(http_server + "/info")
    assert status == 200
    assert body["passage_count"] == 3
    assert body["dimensions"] == 16


def test_search_endpoint(http_server):
    status, body = _post(
        http_server + "/search",
        {"query": "tensor processing units and the MXU", "top_k": 2},
    )
    assert status == 200
    assert body["results"][0]["id"] == "t1"
    assert "took_ms" in body


def test_search_with_filter(http_server):
    status, body = _post(
        http_server + "/search",
        {"query": "anything", "top_k": 3, "filter": "n>=2"},
    )
    assert status == 200
    assert all(r["metadata"]["n"] >= 2 for r in body["results"])


def test_search_missing_query_400(http_server):
    status, body = _post(http_server + "/search", {"top_k": 2})
    assert status == 400
    assert "query" in body["error"]


def test_search_invalid_json_400(http_server):
    import urllib.error

    req = urllib.request.Request(
        http_server + "/search", data=b"{not json", method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            status = r.status
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 400


def test_unknown_route_404(http_server):
    import urllib.error

    try:
        urllib.request.urlopen(http_server + "/nope", timeout=10)
        status = 200
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 404


# ---------------- MCP ----------------


def _mcp_roundtrip(tmp_index_base, messages, monkeypatch=None, cwd=None):
    server = McpServer(default_index=None, device="cpu")
    stdin = io.StringIO("\n".join(json.dumps(m) for m in messages) + "\n")
    stdout = io.StringIO()
    server.run_stdio(stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def test_mcp_initialize_and_tools_list(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    responses = _mcp_roundtrip(None, [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "ping"},
    ])
    assert responses[0]["result"]["serverInfo"]["name"] == "leann-tpu"
    tools = {t["name"] for t in responses[1]["result"]["tools"]}
    assert tools == {"search", "list_indexes"}
    assert responses[2]["result"] == {}


def test_mcp_search_tool(tmp_path, monkeypatch):
    # build an index in a temp cwd so the MCP server can find it by name
    monkeypatch.chdir(tmp_path)
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    base = str(tmp_path / ".leann" / "indexes" / "mcpidx" / "documents.leann")
    builder = IndexBuilder(base, dim=16, device="cpu")
    texts = ["alpha document about foxes", "beta document about TPUs"]
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"m{i}", t, v)
    builder.build()

    responses = _mcp_roundtrip(None, [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/call", "params": {
            "name": "search",
            "arguments": {"query": "beta document about TPUs",
                          "index": "mcpidx", "top_k": 1},
        }},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
            "name": "list_indexes", "arguments": {}}},
    ])
    search_resp = responses[1]["result"]
    assert not search_resp["isError"]
    assert "m1" in search_resp["content"][0]["text"]
    assert "mcpidx" in responses[2]["result"]["content"][0]["text"]


def test_mcp_unknown_tool_and_method(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    responses = _mcp_roundtrip(None, [
        {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
         "params": {"name": "bogus", "arguments": {}}},
        {"jsonrpc": "2.0", "id": 2, "method": "wat/ever"},
    ])
    assert responses[0]["error"]["code"] == -32602
    assert responses[1]["error"]["code"] == -32601


def test_serve_pruned_index_via_recompute(tmp_path, monkeypatch):
    """The HTTP server must serve a pruned index through the recompute
    adapter instead of crashing on the missing embeddings file."""
    import threading

    from leann_tpu_torch.cli.serve_cmd import _PrunedAdapter
    from leann_tpu_torch.index.builder import IndexBuilder
    from leann_tpu_torch.store.embeddings import prune_embeddings
    from leann_tpu_torch.store.meta import meta_path

    base = str(tmp_path / "p" / "documents.leann")
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = ["alpha fox", "beta tpu", "gamma bm25"]
    b = IndexBuilder(base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        b.add(f"t{i}", t, v)
    meta = b.build()
    prune_embeddings(base)
    meta.is_pruned = True
    meta.save(meta_path(base))

    adapter = _PrunedAdapter(base, provider, meta, device="cpu")
    state = ServerState(adapter, provider, None, "p")
    server = serve(state, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        status, body = _post(url + "/search", {"query": "beta tpu", "top_k": 1})
        assert status == 200
        assert body["results"][0]["id"] == "t1"
    finally:
        server.shutdown()
        server.server_close()
        state.batcher.close()


# ------------------------------------------------------------ micro-batching


class _CountingSearcher:
    """Wraps IndexSearcher, counting device-batch calls and batch sizes."""

    def __init__(self, inner):
        self._inner = inner
        self.meta = inner.meta
        self.calls = []

    def search(self, qvecs, options):
        self.calls.append(len(qvecs))
        return self._inner.search(qvecs, options)


def test_microbatch_coalesces_concurrent_requests(tmp_index_base):
    from leann_tpu_torch.server.batching import MicroBatcher
    from leann_tpu_torch.index.searcher import SearchOptions

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"passage number {i} about topic {i % 4}" for i in range(32)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    counting = _CountingSearcher(IndexSearcher.load(tmp_index_base, device="cpu"))
    batcher = MicroBatcher(counting, provider, None,
                           max_batch=64, window_ms=60.0)
    try:
        results = [None] * 8
        errors = []

        def worker(i):
            try:
                results[i] = batcher.submit(
                    texts[i], SearchOptions(top_k=3), timeout=30
                )
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        # every caller got ITS OWN top hit back
        for i, rows in enumerate(results):
            assert rows is not None and rows[0].id == f"t{i}"
        # the 8 requests coalesced into very few device batches
        assert len(counting.calls) <= 3
        assert sum(counting.calls) == 8
    finally:
        batcher.close()


def test_microbatch_groups_by_options(tmp_index_base):
    from leann_tpu_torch.server.batching import MicroBatcher
    from leann_tpu_torch.index.searcher import SearchOptions

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = ["alpha beta", "gamma delta", "epsilon zeta"]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    counting = _CountingSearcher(IndexSearcher.load(tmp_index_base, device="cpu"))
    batcher = MicroBatcher(counting, provider, None,
                           max_batch=8, window_ms=60.0)
    try:
        out = {}

        def worker(key, q, k):
            from leann_tpu_torch.index.searcher import SearchOptions as SO
            out[key] = batcher.submit(q, SO(top_k=k), timeout=30)

        ts = [
            threading.Thread(target=worker, args=("a", texts[0], 1)),
            threading.Thread(target=worker, args=("b", texts[1], 1)),
            threading.Thread(target=worker, args=("c", texts[2], 2)),
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert out["a"][0].id == "t0" and len(out["a"]) == 1
        assert out["b"][0].id == "t1"
        assert out["c"][0].id == "t2" and len(out["c"]) == 2
    finally:
        batcher.close()


def test_microbatch_propagates_errors(tmp_index_base):
    from leann_tpu_torch.server.batching import MicroBatcher
    from leann_tpu_torch.index.searcher import SearchOptions

    class BoomProvider:
        def embed_with_template(self, texts, template):
            raise RuntimeError("embed exploded")

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    builder.add("t0", "hello", provider.embed(["hello"])[0], {})
    builder.build()
    searcher = IndexSearcher.load(tmp_index_base, device="cpu")
    batcher = MicroBatcher(searcher, BoomProvider(), None,
                           max_batch=4, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="embed exploded"):
            batcher.submit("hello", SearchOptions(top_k=1), timeout=10)
    finally:
        batcher.close()


def test_search_batch_endpoint(http_server):
    status, body = _post(
        http_server + "/search",
        {"queries": ["tensor processing units and the MXU",
                     "bm25 ranking function"], "top_k": 1},
    )
    assert status == 200
    per_q = body["results_per_query"]
    assert len(per_q) == 2
    assert per_q[0][0]["id"] == "t1"
    assert per_q[1][0]["id"] == "t2"


def test_search_batch_endpoint_rejects_bad_list(http_server):
    status, body = _post(
        http_server + "/search", {"queries": ["ok", 42], "top_k": 1}
    )
    assert status == 400


def test_microbatch_flush_pipeline_overlaps(tmp_index_base):
    """Consecutive flushes must be able to run concurrently (depth-2
    pipeline): with a slow searcher, two batches submitted a window
    apart should overlap rather than serialize."""
    import time as _time

    from leann_tpu_torch.index.searcher import SearchOptions
    from leann_tpu_torch.server.batching import MicroBatcher

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"doc {i}" for i in range(8)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v)
    builder.build()

    inner = IndexSearcher.load(tmp_index_base, device="cpu")
    in_flight = []
    lock = threading.Lock()

    class Slow:
        meta = inner.meta

        def search(self, qvecs, options):
            with lock:
                in_flight.append(1)
                peak = sum(in_flight)
            # sleep must dominate the real search cost or the
            # wall-clock bound below can't separate pipelined from
            # serialized
            _time.sleep(0.5)
            out = inner.search(qvecs, options)
            with lock:
                in_flight.pop()
            self.peak = max(getattr(self, "peak", 0), peak)
            return out

    slow = Slow()
    batcher = MicroBatcher(slow, provider, None, max_batch=1,
                           window_ms=0.0, pipeline_depth=2)
    try:
        results = [None] * 4
        def worker(i):
            results[i] = batcher.submit(texts[i], SearchOptions(top_k=2),
                                        timeout=30)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        t0 = _time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = _time.time() - t0
        assert all(r is not None and len(r) == 2 for r in results)
        # peak >= 2 is the PRIMARY assertion: two searches observed
        # in flight at once is direct, load-independent proof of
        # overlap (serialized flushes can never show peak > 1). The
        # wall bound is a gross-serialization catch only: 4 x 0.5s
        # serialized = 2.0s+ BEFORE search costs, so 2.4 separates the
        # regimes even when the host is under concurrent load.
        assert getattr(slow, "peak", 1) >= 2
        assert elapsed < 2.4, f"flushes serialized ({elapsed:.2f}s)"
    finally:
        batcher.close()


def test_microbatch_hybrid_shares_one_dispatch(tmp_index_base):
    """Regression: hybrid requests must share the vector-search device
    dispatch (query_text used to be part of the group key, making every
    hybrid request a singleton group — hybrid_latency measured ~900ms
    p50 at 32 clients from the resulting dispatch serialization), while
    each row still gets ITS OWN BM25 rescore via query_texts."""
    from leann_tpu_torch.server.batching import MicroBatcher
    from leann_tpu_torch.index.searcher import SearchOptions

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"word{i} unique{i} topic" for i in range(12)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    counting = _CountingSearcher(IndexSearcher.load(tmp_index_base, device="cpu"))
    batcher = MicroBatcher(counting, provider, None,
                           max_batch=16, window_ms=60.0)
    try:
        results = [None] * 6
        errors = []

        def worker(i):
            try:
                results[i] = batcher.submit(
                    texts[i],
                    SearchOptions(top_k=3, hybrid=True, query_text=texts[i]),
                    timeout=30,
                )
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        # all 6 hybrid requests shared very few device dispatches
        assert len(counting.calls) <= 2
        assert sum(counting.calls) == 6
        # and each caller's own text drove its result
        for i, rows in enumerate(results):
            assert rows is not None and rows[0].id == f"t{i}"
    finally:
        batcher.close()


def test_microbatch_plain_and_hybrid_share_group(tmp_index_base):
    """Plain and hybrid requests differ only in host-side rescoring, so
    they must land in the same batch group (one device dispatch); the
    hybrid rows get their BM25 rescore, the plain rows must not."""
    from leann_tpu_torch.server.batching import MicroBatcher, _options_key
    from leann_tpu_torch.index.searcher import SearchOptions

    assert _options_key(SearchOptions(top_k=3)) == _options_key(
        SearchOptions(top_k=3, hybrid=True, query_text="anything"))

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"word{i} unique{i} topic" for i in range(12)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    counting = _CountingSearcher(IndexSearcher.load(tmp_index_base, device="cpu"))
    batcher = MicroBatcher(counting, provider, None,
                           max_batch=16, window_ms=60.0)
    try:
        results = [None] * 6
        errors = []

        def worker(i):
            hybrid = i % 2 == 0
            opts = SearchOptions(
                top_k=3, hybrid=hybrid,
                query_text=texts[i] if hybrid else None)
            try:
                results[i] = batcher.submit(texts[i], opts, timeout=30)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        # plain + hybrid coalesced into very few dispatches
        assert len(counting.calls) <= 2
        assert sum(counting.calls) == 6
        for i, rows in enumerate(results):
            assert rows is not None and rows[0].id == f"t{i}"
            if i % 2 == 0:
                # hybrid rows carry blended [0,1] scores
                assert 0.0 <= rows[0].score <= 1.0 + 1e-6
    finally:
        batcher.close()


def test_server_state_warm(tmp_index_base):
    """warm() precompiles one program per pow-2 bucket and must run
    against a real searcher+meta (regression: it read meta.dim, which
    does not exist — meta.dimensions is the field)."""
    from leann_tpu_torch.server.http import ServerState

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"doc {i}" for i in range(8)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {})
    builder.build()
    state = ServerState(
        IndexSearcher.load(tmp_index_base, device="cpu"), provider, None, "warmtest",
        max_batch=8)
    try:
        assert state.warm() == 4  # buckets 1, 2, 4, 8
        # non-pow-2 max_batch (ADVICE r4): a flush of 5-6 rows pads to
        # bucket 8, so warm must compile PAST mb, not stop at b == mb
        assert state.warm(max_batch=6) == 4  # buckets 1, 2, 4, 8
    finally:
        state.batcher.close()


# ------------------------------------------------------- the port's own cases


def _serve_both(tmp_index_base, texts):
    """One index (built by the port), served by the reference's HTTP server
    and by the port's; yields both base URLs."""
    from leann_tpu.embed import EmbeddingProvider as RefProvider
    from leann_tpu.index.searcher import IndexSearcher as RefSearcher
    from leann_tpu.server.http import ServerState as RefState
    from leann_tpu.server.http import serve as ref_serve

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    states = [
        RefState(RefSearcher.load(tmp_index_base),
                 RefProvider(mode="fake", dimensions=16), None, "twin"),
        ServerState(IndexSearcher.load(tmp_index_base, device="cpu"),
                    provider, None, "twin"),
    ]
    servers = [ref_serve(states[0], port=0), serve(states[1], port=0)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    return states, servers


def _without_timing(body):
    body = dict(body)
    body.pop("took_ms", None)
    return body


def test_http_bodies_equal_reference_server(tmp_index_base):
    """GET /, /health, /info and POST /search (one query, a batch, a
    filter, hybrid, the 400s) return the reference server's bodies; the
    scores agree within 1e-6 (float32 rescores summed in another
    order)."""
    texts = [f"passage {i} about topic {i % 5} and word{i}" for i in range(40)]
    states, servers = _serve_both(tmp_index_base, texts)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    try:
        for path in ("/", "/health", "/info"):
            ref, got = (_get(u + path) for u in urls)
            assert got == ref, path
        payloads = [
            {"query": texts[3], "top_k": 4},
            {"query": texts[7], "top_k": 3, "filter": "n>=20"},
            {"query": "word12 topic", "top_k": 3, "hybrid": True},
            {"queries": texts[:5], "top_k": 2},
            {"queries": texts[5:8], "top_k": 2, "hybrid": True},
            {"top_k": 2},
            {"queries": ["ok", 42]},
        ]
        for payload in payloads:
            (rs, ref), (gs, got) = (_post(u + "/search", payload)
                                    for u in urls)
            assert gs == rs, payload
            ref, got = _without_timing(ref), _without_timing(got)
            rows_r = ref.get("results_per_query") or [ref.get("results")]
            rows_g = got.get("results_per_query") or [got.get("results")]
            for a, b in zip(rows_r, rows_g):
                if a is None:
                    continue
                assert [r["score"] for r in b] == pytest.approx(
                    [r["score"] for r in a], abs=1e-6), payload
                for r in a + b:
                    r["score"] = None
            assert got == ref, payload
    finally:
        for s, st in zip(servers, states):
            s.shutdown()
            s.server_close()
            st.batcher.close()


def test_mcp_replies_equal_reference_server(tmp_path, monkeypatch):
    from leann_tpu.server.mcp import McpServer as RefMcp

    monkeypatch.chdir(tmp_path)
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    base = str(tmp_path / ".leann" / "indexes" / "twin" / "documents.leann")
    builder = IndexBuilder(base, dim=16, device="cpu")
    texts = [f"document {i} on subject {i % 3}" for i in range(12)]
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"m{i}", t, v, {"source": f"src/m{i}.md"})
    builder.build()
    msgs = [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
            "name": "search", "arguments": {"query": texts[4], "top_k": 3}}},
        {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {
            "name": "search", "arguments": {"query": texts[9], "top_k": 2,
                                            "filter": "source:*m9.md"}}},
        {"jsonrpc": "2.0", "id": 5, "method": "tools/call", "params": {
            "name": "list_indexes", "arguments": {}}},
        {"jsonrpc": "2.0", "id": 6, "method": "nope"},
    ]
    ref, port = RefMcp(default_index="twin"), McpServer("twin", device="cpu")
    for m in msgs:
        assert port.handle(m) == ref.handle(m), m["method"]


def test_server_state_warm_default_lattice(tmp_index_base):
    """At the default max_batch of 64 warm issues 7 searches (1..64)."""
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, v in enumerate(provider.embed([f"d {i}" for i in range(8)])):
        builder.add(f"t{i}", f"d {i}", v, {})
    builder.build()
    searcher = _CountingSearcher(IndexSearcher.load(tmp_index_base,
                                                    device="cpu"))
    state = ServerState(searcher, provider, None, "w")
    try:
        assert state.warm() == 7
        assert searcher.calls == [1, 2, 4, 8, 16, 32, 64]
    finally:
        state.batcher.close()


def test_launch_counter_is_exact_under_threads():
    """The kernel wrappers' launch counters take a lock: 16 threads of
    2,000 increments each, with a short switch interval, lose none."""
    import sys

    from leann_tpu_torch.ops import _cuda

    class Wrapper:
        launches = 0

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _cuda.count_launch(Wrapper)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert Wrapper.launches == 16 * 2000


def test_concurrent_hybrid_flushes_share_one_bm25_load(tmp_index_base,
                                                       monkeypatch):
    """Two flush threads race on the searcher's first BM25 use: the
    sidecar loads once, and every hybrid row is rescored with it."""
    from leann_tpu_torch.index import bm25 as bm25_mod
    from leann_tpu_torch.index.searcher import SearchOptions
    from leann_tpu_torch.server.batching import MicroBatcher

    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"word{i} unique{i} topic" for i in range(24)]
    builder = IndexBuilder(tmp_index_base, dim=16, device="cpu")
    for i, (t, v) in enumerate(zip(texts, provider.embed(texts))):
        builder.add(f"t{i}", t, v, {"n": i})
    builder.build()
    loads = []
    real_load = bm25_mod.Bm25Scorer.load

    def slow_load(path):
        loads.append(path)
        import time as _time

        _time.sleep(0.2)
        return real_load(path)

    monkeypatch.setattr(bm25_mod.Bm25Scorer, "load", staticmethod(slow_load))
    batcher = MicroBatcher(IndexSearcher.load(tmp_index_base, device="cpu"),
                           provider, None, max_batch=2, window_ms=0.0,
                           pipeline_depth=2)
    try:
        results = [None] * 8

        def worker(i):
            results[i] = batcher.submit(
                texts[i], SearchOptions(top_k=3, hybrid=True,
                                        query_text=texts[i]), timeout=30)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert len(loads) == 1
    # each row equals the same hybrid search run alone; a row that missed
    # the scorer would carry the vector ranking and raw inner products
    alone = IndexSearcher.load(tmp_index_base, device="cpu")
    for i, rows in enumerate(results):
        want = alone.search(provider.embed([texts[i]]), SearchOptions(
            top_k=3, hybrid=True, query_text=texts[i]))[0]
        assert [(r.id, r.score) for r in rows] == [
            (r.id, r.score) for r in want]
