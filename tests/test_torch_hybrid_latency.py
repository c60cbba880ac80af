"""BASELINE config 4's eval in the port
(`leann_tpu_torch/evals/hybrid_latency.py`) against the reference's
`evals/hybrid_latency.py`, on the CPU at a small size (N = 2,000, d = 32).

The texts, the index files both packages build, and what both HTTP
servers answer to the drive's own requests are held equal (ids exactly,
scores within 1e-5: the float32 rescores sum in another order); the
port's served results also equal `IndexSearcher.search` called directly.
Then `main` end to end with `--device cpu`, its refusal without CUDA,
and that it imports no JAX and nothing of `leann_tpu`.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from leann_tpu_torch.embed import EmbeddingProvider
from leann_tpu_torch.evals import hybrid_latency as th
from leann_tpu_torch.index.searcher import IndexSearcher
from leann_tpu_torch.server.http import ServerState, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 2000, 32

torch.set_num_threads(1)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_hybrid_latency",
        os.path.join(ROOT, "evals", "hybrid_latency.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jh = _reference()

# the reference's total row (evals/hybrid_latency.py:230-237) is built
# inline in its main, so its keys are named here
REFERENCE_TOTAL_KEYS = {"metric", "window_ms", "clients", "qps", "errors",
                        "n"}


def test_make_texts_equals_reference():
    assert th.make_texts(5000, 0) == jh.make_texts(5000, 0)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The same N built by each package's `build_index`: (reference base,
    port base)."""
    root = tmp_path_factory.mktemp("hybrid")
    ref = str(root / "ref" / "documents.leann")
    port = str(root / "port" / "documents.leann")
    os.makedirs(os.path.dirname(ref))
    jh.build_index(ref, N, D)
    steps = th.build_index(port, N, D, device="cpu")
    assert set(steps) == {"texts_s", "embed_add_s", "build_s", "bm25_s",
                          "bm25_native"}
    return ref, port


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_build_index_files_equal_reference(indexes):
    ref, port = indexes
    for ext in (".passages.jsonl", ".passages.idx.json", ".ids.txt"):
        assert _bytes(port + ext) == _bytes(ref + ext), ext
    np.testing.assert_array_equal(
        np.fromfile(port + ".embeddings", np.float32),
        np.fromfile(ref + ".embeddings", np.float32))
    with np.load(ref + ".bm25.npz") as a, np.load(port + ".bm25.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    # no field of the meta records a time or a package version (`version`
    # is the file format's, "1.0" in both), so the whole meta is compared
    with open(ref + ".meta.json") as f:
        ref_meta = json.load(f)
    with open(port + ".meta.json") as f:
        port_meta = json.load(f)
    assert port_meta == ref_meta
    assert port_meta["backend_name"] == "flat"
    assert port_meta["metric"] == "ip"


def _requests_of_client0(per_mix=10):
    """The first `per_mix` requests of each mix that `drive`'s client 0
    sends (seed 0), in the order it draws them."""
    got, count = [], {m: 0 for m in th.MIXES}
    for mix, body in th.client_requests(0, 0):
        if count[mix] < per_mix:
            got.append((mix, body))
            count[mix] += 1
        if min(count.values()) == per_mix:
            return got


def _post(url, body):
    req = urllib.request.Request(
        url + "/search", data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200
        return json.loads(r.read())["results"]


def test_client_requests_follow_the_reference_draws():
    """The stream draws as the reference's `one_client` does: 2-5 words
    of w00000-w02999, then the roll, from default_rng(seed * 1000 + cid)."""
    r = np.random.default_rng(3 * 1000 + 5)
    stream = th.client_requests(3, 5)
    for _ in range(50):
        nw = int(r.integers(2, 6))
        q = " ".join(f"w{int(r.integers(0, 3000)):05d}" for _ in range(nw))
        roll = r.random()
        mix, body = next(stream)
        assert body["query"] == q
        assert mix == ("plain" if roll < 0.6 else
                       "hybrid" if roll < 0.9 else "hybrid_filter")
        assert body.get("hybrid", False) == (mix != "plain")
        assert body.get("filter") == (
            "source$py" if mix == "hybrid_filter" else None)


def test_served_results_equal_reference_and_direct_search(indexes):
    """Each package serves the index the other built: 10 requests of each
    mix, posted one at a time, return equal ids (scores within 1e-5);
    the port's equal its searcher called directly."""
    from leann_tpu.embed import EmbeddingProvider as RefProvider
    from leann_tpu.index.searcher import IndexSearcher as RefSearcher
    from leann_tpu.server.http import ServerState as RefState
    from leann_tpu.server.http import serve as ref_serve

    ref_base, port_base = indexes
    provider = EmbeddingProvider(mode="fake", dimensions=D)
    searcher = IndexSearcher(ref_base, device="cpu")
    states = [
        RefState(RefSearcher(port_base), RefProvider(mode="fake",
                                                     dimensions=D),
                 None, "hybrid_bench", max_batch=64, batch_window_ms=2),
        ServerState(searcher, provider, None, "hybrid_bench", max_batch=64,
                    batch_window_ms=2),
    ]
    servers = [ref_serve(states[0], port=0), serve(states[1], port=0)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    ref_url, port_url = (f"http://127.0.0.1:{s.server_address[1]}"
                         for s in servers)
    try:
        seen = set()
        for mix, body in _requests_of_client0():
            ref, got = _post(ref_url, body), _post(port_url, body)
            seen.add(mix)
            assert [h["id"] for h in got] == [h["id"] for h in ref], body
            np.testing.assert_allclose(
                [h["score"] for h in got], [h["score"] for h in ref],
                rtol=1e-5, atol=1e-5)
            assert [(h["text"], h["metadata"]) for h in got] == [
                (h["text"], h["metadata"]) for h in ref]
            direct = searcher.search(provider.embed([body["query"]]),
                                     th.options_of(body))[0]
            assert [h["id"] for h in got] == [h.id for h in direct], body
            np.testing.assert_allclose(
                [h["score"] for h in got], [h.score for h in direct],
                rtol=1e-5, atol=1e-5)
            if mix == "hybrid_filter":
                assert all(h["metadata"]["source"].endswith(".py")
                           for h in got)
            else:
                assert len(got) == 10
        assert seen == set(th.MIXES)
    finally:
        for s, st in zip(servers, states):
            s.shutdown()
            s.server_close()
            st.batcher.close()


def test_filter_holds_flags_a_hit_outside_the_filter():
    ok = json.dumps({"results": [{"metadata": {"source": "src/m1.py"}}]})
    bad = json.dumps({"results": [{"metadata": {"source": "src/m2.md"}}]})
    assert th.filter_holds("hybrid_filter", ok.encode())
    assert not th.filter_holds("hybrid_filter", bad.encode())
    assert th.filter_holds("plain", bad.encode())


ARGS = ["--n", str(N), "--d", str(D), "--clients", "4", "--duration", "1",
        "--windows", "0", "--device", "cpu", "--port", "0"]


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_main_on_the_cpu_prints_the_reference_rows(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(th, "ADIR", str(tmp_path))
    assert th.main(ARGS) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r["metric"] for r in rows] == ["hybrid_latency"] * 3 + [
        "hybrid_latency_total"]
    assert [r["mix"] for r in rows[:3]] == list(th.MIXES)
    mix_keys = set(jh.percentile_row([1.0], "plain", 0.0, 4))
    for r in rows[:3]:
        assert set(r) == mix_keys | {"device"}
        assert r["device"] == "cpu" and r["requests"] > 0
        assert r["window_ms"] == 0.0 and r["clients"] == 4
    total = rows[3]
    assert set(total) == REFERENCE_TOTAL_KEYS | {"device"}
    # errors also counts every filtered reply with a hit outside source$py
    assert total["errors"] == 0
    assert total["n"] == N and total["qps"] > 0
    assert os.path.exists(os.path.join(
        str(tmp_path), f"hybrid_idx_n{N}_d{D}", "documents.leann.meta.json"))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "LEANN_TORCH_DEVICE"}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [ROOT, env.get("PYTHONPATH", "")] if p)
    env.update(extra)
    return env


def test_without_cuda_prints_one_error_line_and_fails(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "leann_tpu_torch.evals.hybrid_latency",
         "--n", "100"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["error"].startswith("CUDA unavailable")


def test_main_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from leann_tpu_torch.evals import hybrid_latency as h\n"
        f"h.ADIR = {str(tmp_path)!r}\n"
        f"assert h.main({ARGS!r}) == 0\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax') or "
        "m.split('.')[0] == 'leann_tpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_env())
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    assert len(_rows(p.stdout)) == 4
