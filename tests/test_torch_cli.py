"""The port's CLI (`leann_tpu_torch.cli.main.main(argv)`) against the
reference's (`leann_tpu.cli.main.main`), on the CPU
(`LEANN_TORCH_DEVICE=cpu`, set by the fixture).

- (a) Every case of tests/test_cli.py with the same argv on the port:
  the whole command surface in a temporary working directory and HOME
  with the fake embedder. The sharded case passes
  `--device cpu,cpu,...` (eight) in place of the reference's 8 virtual
  CPU devices.
- (b) Cross-package: an index built by either CLI is searched by both
  with equal top-1 ids (flat and hnsw); `update` (graph and IVF) and
  `reindex --backend-name ivf` write `graph.npz` / `ivf.npz` equal to
  what the reference's CLI writes from the same inputs (ids and
  assignments exactly, centers within 1e-5); `search --format json` on a
  flat index gives the same output but for the score values, which
  agree within 1e-6 (both rescore in float32; XLA's CPU contraction and
  torch's sum each dot in another order, so the last bit may differ);
  `--device cuda` without CUDA returns 1 with `resolve_device`'s message
  and runs nothing; a fresh interpreter runs `build` and `search` through
  the port's CLI and the servers' modules with no jax* and no
  leann_tpu.* in sys.modules.
"""

import json
import os

import pytest

from leann_tpu_torch.cli.main import main


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "animals.md").write_text(
        "The quick brown fox jumps over the lazy dog. Foxes live in forests."
    )
    (docs / "hardware.md").write_text(
        "Tensor processing units accelerate matrix multiplication on the MXU."
    )
    (docs / "code.py").write_text(
        "def search_index(query):\n    return ann.search(query)\n"
    )
    monkeypatch.chdir(tmp_path)
    # isolate global index dir + config
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "home" / ".config"))
    monkeypatch.setenv("LEANN_TORCH_DEVICE", "cpu")
    return tmp_path


def _build(workdir, name="testidx", extra=None):
    args = [
        "build", name, "--docs", "docs",
        "--embedding-mode", "fake", "--embedding-dimensions", "32",
        "--backend-name", "flat",
    ] + (extra or [])
    assert main(args) == 0


def test_build_and_search(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    rc = main(["search", 'Tensor processing units accelerate matrix multiplication on the MXU.',
               "-i", "testidx", "--top-k", "2", "--no-expand"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hardware.md" in out


def test_build_refuses_overwrite_without_force(workdir, capsys):
    _build(workdir)
    rc = main(["build", "testidx", "--docs", "docs",
               "--embedding-mode", "fake", "--embedding-dimensions", "32"])
    assert rc == 1
    assert "--force" in capsys.readouterr().err
    _build(workdir, extra=["--force"])


def test_search_json_format(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    rc = main(["search", 'The quick brown fox jumps over the lazy dog. Foxes live in forests.',
               "-i", "testidx", "--format", "json", "--top-k", "1"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert isinstance(data, list) and data
    assert "animals.md" in data[0]["id"]


def test_search_with_filter(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    rc = main(["search", "anything at all really", "-i", "testidx",
               "--filter", "source$py", "--format", "json", "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert data and all(r["metadata"]["source"].endswith(".py") for r in data)


def test_list_and_remove(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "testidx" in out and "OK" in out
    assert main(["remove", "testidx", "-y"]) == 0
    capsys.readouterr()
    assert main(["list"]) == 0
    assert "testidx" not in capsys.readouterr().out


def test_prune_then_search_recompute(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    assert main(["prune", "testidx", "-y"]) == 0
    out = capsys.readouterr().out
    assert "freed" in out
    rc = main(["search", 'The quick brown fox jumps over the lazy dog. Foxes live in forests.',
               "-i", "testidx", "--format", "json", "--top-k", "1"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "animals.md" in data[0]["id"]


def test_update_adds_documents(workdir, capsys):
    _build(workdir)
    (workdir / "docs" / "extra.md").write_text(
        "Approximate nearest neighbor search with Vamana graphs and beams."
    )
    capsys.readouterr()
    assert main(["update", "testidx", "--docs", "docs"]) == 0
    assert "Added" in capsys.readouterr().out
    rc = main(["search", 'Approximate nearest neighbor search with Vamana graphs and beams.',
               "-i", "testidx", "--format", "json", "--top-k", "1",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "extra.md" in data[0]["id"]


def test_ask_with_simulated_llm(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    rc = main(["ask", "what do foxes do?", "-i", "testidx",
               "--llm", "simulated", "--show-sources"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "simulated" in out.lower()
    assert "Sources:" in out


def test_react_with_simulated_llm(workdir, capsys):
    _build(workdir)
    capsys.readouterr()
    rc = main(["react", "what accelerates matmuls?", "-i", "testidx",
               "--llm", "simulated", "--show-steps"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "answer" in out.lower()


def test_config_show_and_path(workdir, capsys):
    assert main(["config", "path"]) == 0
    path = capsys.readouterr().out.strip()
    assert path.endswith("config.toml")
    assert main(["config", "init"]) == 0
    capsys.readouterr()
    assert main(["config", "show"]) == 0
    out = capsys.readouterr().out
    assert "[embedding]" in out and "[build]" in out


def test_vamana_build_via_cli(workdir, capsys):
    _build(workdir, name="gidx",
           extra=["--backend-name", "hnsw", "--graph-degree", "8",
                  "--complexity", "16"])
    capsys.readouterr()
    rc = main(["search", 'Tensor processing units accelerate matrix multiplication on the MXU.',
               "-i", "gidx", "--format", "json", "--top-k", "1",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "hardware.md" in data[0]["id"]


def test_search_missing_index_friendly_error(workdir, capsys):
    rc = main(["search", "x", "-i", "nope"])
    assert rc == 1
    assert "not found" in capsys.readouterr().err


def test_gitignore_respected(workdir, capsys):
    (workdir / "docs" / ".gitignore").write_text("secret.md\n")
    (workdir / "docs" / "secret.md").write_text("do not index this secret")
    _build(workdir, name="gitidx")
    capsys.readouterr()
    rc = main(["search", "secret", "-i", "gitidx", "--format", "json",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert all("secret.md" not in r["id"] for r in data)


def test_resume_interrupted_build(workdir, capsys):
    """Kill a build mid-stream (simulated via checkpoint), resume, and the
    final index must be complete and searchable."""
    import numpy as np
    from leann_tpu_torch.embed import EmbeddingProvider
    from leann_tpu_torch.index.builder import StreamingIndexBuilder, ckpt_path
    from leann_tpu_torch.store.passages import Passage

    base = str(workdir / ".leann" / "indexes" / "resum" / "documents.leann")
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    texts = [f"chunk number {i}" for i in range(20)]

    # phase 1: ingest half, checkpoint, then "crash" (add garbage rows
    # after the checkpoint that must be truncated away on resume)
    b1 = StreamingIndexBuilder(base, dim=16, device="cpu")
    for i in range(10):
        b1.add_passage(Passage(f"c{i}", texts[i]), provider.embed([texts[i]])[0])
    b1.checkpoint(files_done=0)
    b1.add_passage(Passage("garbage", "partial"), provider.embed(["partial"])[0])
    b1._passages._f.flush()
    b1._embeddings._f.flush()
    # simulate process death: no finish(), no meta
    assert os.path.exists(ckpt_path(base))

    # phase 2: resume and ingest the rest
    b2 = StreamingIndexBuilder(base, dim=16, resume=True, device="cpu")
    assert len(b2) == 10  # garbage row truncated
    assert not b2.has_id("garbage")
    for i in range(10, 20):
        b2.add_passage(Passage(f"c{i}", texts[i]), provider.embed([texts[i]])[0])
    meta = b2.build()
    assert meta.passage_count == 20
    assert not os.path.exists(ckpt_path(base))

    from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions

    s = IndexSearcher.load(base, device="cpu")
    res = s.search(provider.embed([texts[3]]), SearchOptions(top_k=1))[0]
    assert res[0].id == "c3"
    res = s.search(provider.embed([texts[17]]), SearchOptions(top_k=1))[0]
    assert res[0].id == "c17"


def test_metrics_endpoint_and_spans(workdir):
    import threading
    import urllib.request

    from leann_tpu_torch.embed import EmbeddingProvider
    from leann_tpu_torch.index.builder import IndexBuilder
    from leann_tpu_torch.index.searcher import IndexSearcher, SearchOptions
    from leann_tpu_torch.server.http import ServerState, serve
    from leann_tpu_torch.utils import METRICS

    METRICS.reset()
    base = str(workdir / ".leann" / "indexes" / "m" / "documents.leann")
    provider = EmbeddingProvider(mode="fake", dimensions=16)
    b = IndexBuilder(base, dim=16, device="cpu")
    for i in range(5):
        b.add(f"x{i}", f"text {i}", provider.embed([f"text {i}"])[0])
    b.build()
    searcher = IndexSearcher.load(base, device="cpu")
    searcher.search(provider.embed(["text 1"]), SearchOptions(top_k=2))

    snap = METRICS.snapshot()
    assert snap["search.requests"]["value"] == 1
    assert "span.search.ann.seconds" in snap

    state = ServerState(searcher, provider, None, "m")
    server = serve(state, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
        assert "search_requests" in body
        assert "span_search_ann_seconds" in body
    finally:
        server.shutdown()
        server.server_close()
        state.batcher.close()


def test_config_file_provider_precedence(workdir, capsys):
    """CLI default embedding-mode 'openai' yields to the config file's
    provider (reference build.rs:160-172)."""
    import pathlib

    cfg_dir = pathlib.Path(os.environ["XDG_CONFIG_HOME"]) / "leann"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.toml").write_text(
        '[embedding]\nprovider = "fake"\nmodel = "fake"\n'
    )
    rc = main(["build", "cfgidx", "--docs", "docs",
               "--embedding-dimensions", "16"])  # no --embedding-mode
    assert rc == 0
    out = capsys.readouterr().out
    assert "fake/fake" in out


def test_update_ivf_backend(workdir, capsys):
    _build(workdir, name="ividx", extra=["--backend-name", "ivf"])
    (workdir / "docs" / "late.md").write_text(
        "A very late addition mentioning quasars and pulsars."
    )
    assert main(["update", "ividx", "--docs", "docs"]) == 0
    capsys.readouterr()
    rc = main(["search", "A very late addition mentioning quasars and pulsars.",
               "-i", "ividx", "--format", "json", "--top-k", "1",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "late.md" in data[0]["id"]


def test_search_sharded_over_device_mesh(workdir, capsys):
    """--sharded serves exact search over a mesh of 8 CPU devices (the
    reference's 8 virtual CPU devices), laid by --device."""
    _build(workdir)
    capsys.readouterr()
    rc = main(["--device", ",".join(["cpu"] * 8), "search", 'Tensor processing units accelerate matrix multiplication on the MXU.',
               "-i", "testidx", "--format", "json", "--top-k", "1",
               "--no-expand", "--sharded"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "hardware.md" in data[0]["id"]


def test_reindex_switches_backend_without_reembedding(workdir, capsys):
    _build(workdir)  # flat
    capsys.readouterr()
    # switch to ivf
    assert main(["reindex", "testidx", "--backend-name", "ivf"]) == 0
    out = capsys.readouterr().out
    assert "backend=ivf" in out
    rc = main(["search", 'The quick brown fox jumps over the lazy dog. Foxes live in forests.',
               "-i", "testidx", "--format", "json", "--top-k", "1",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "animals.md" in data[0]["id"]
    # and to vamana
    assert main(["reindex", "testidx", "--backend-name", "vamana",
                 "--graph-degree", "4", "--complexity", "8"]) == 0
    capsys.readouterr()
    rc = main(["search", 'Tensor processing units accelerate matrix multiplication on the MXU.',
               "-i", "testidx", "--format", "json", "--top-k", "1",
               "--no-expand"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert "hardware.md" in data[0]["id"]


def test_reindex_refuses_pruned(workdir, capsys):
    _build(workdir)
    assert main(["prune", "testidx", "-y"]) == 0
    capsys.readouterr()
    assert main(["reindex", "testidx", "--backend-name", "ivf"]) == 1
    assert "pruned" in capsys.readouterr().err


def test_update_vamana_remaps_stale_sentinels(workdir, capsys):
    """Growing a vamana index must not turn the old sentinel pads
    (value == old_n) into real edges to the first newly added node
    (ADVICE r1: 66 pads became 40 edges on a 30+5 update)."""
    import numpy as np

    from leann_tpu_torch.store.graphfile import GraphFile, graph_path
    from leann_tpu_torch.store.locate import find_index, index_base
    from leann_tpu_torch.store.passages import read_ids

    _build(workdir, name="vamidx",
           extra=["--backend-name", "vamana", "--graph-degree", "16"])
    base = index_base(find_index("vamidx"))
    old_n = len(read_ids(base))
    (workdir / "docs" / "extra.md").write_text(
        "Completely new content about distributed beam search engines."
    )
    capsys.readouterr()
    assert main(["update", "vamidx", "--docs", "docs"]) == 0
    adj = GraphFile.load(graph_path(base)).adjacency
    n_total = adj.shape[0]
    assert n_total > old_n
    # edges into node old_n from the OLD rows can only be genuine
    # (reverse-edge) links, never a whole row of recycled pads
    hits = int((np.asarray(adj[:old_n]) == old_n).sum())
    assert hits <= adj.shape[1], (
        f"{hits} edges to node {old_n}: stale sentinel pads leaked"
    )


def test_build_persists_reference_template_keys(workdir, capsys):
    """A custom --embedding-prompt-template is stored under the
    reference's embedding_options keys (build.rs:344-352), and
    re-embedding paths honor it."""
    from leann_tpu_torch.cli.common import (
        provider_from_meta,
        resolve_build_template,
    )
    from leann_tpu_torch.store.locate import find_index, index_base
    from leann_tpu_torch.store.meta import IndexMeta, meta_path

    _build(workdir, name="tplidx",
           extra=["--embedding-prompt-template", "DOC: "])
    meta = IndexMeta.load(meta_path(index_base(find_index("tplidx"))))
    opts = meta.embedding_options or {}
    assert opts.get("build_prompt_template") == "DOC: "
    assert "query_prompt_template" in opts
    assert "prompt_template" not in opts
    provider = provider_from_meta(meta)
    assert resolve_build_template(meta, provider) == "DOC: "


# ------------------------------------------------- (b) cross-package cases

import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

import numpy as np  # noqa: E402

from leann_tpu.cli.main import main as ref_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(300)]


def _more_docs(workdir, n, prefix="d", seed=0):
    """n one-chunk markdown files of 20 random words; returns their texts."""
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, 20)) for _ in range(n)]
    for i, t in enumerate(texts):
        (workdir / "docs" / f"{prefix}{i}.md").write_text(t)
    return texts


def _json_search(cli, capsys, query, name, top_k=5):
    capsys.readouterr()
    assert cli(["search", query, "-i", name, "--format", "json",
                "--top-k", str(top_k), "--no-expand",
                "--no-auto-hybrid"]) == 0
    return capsys.readouterr().out


def _index_dir(workdir, name):
    return workdir / ".leann" / "indexes" / name


@pytest.mark.parametrize("backend", ["flat", "hnsw"])
@pytest.mark.parametrize("builder", ["reference", "port"])
def test_index_built_by_either_cli_searches_in_the_other(
        workdir, capsys, backend, builder):
    texts = _more_docs(workdir, 24)
    build = ref_main if builder == "reference" else main
    assert build(["build", "x", "--docs", "docs", "--embedding-mode", "fake",
                  "--embedding-dimensions", "32", "--backend-name", backend,
                  "--graph-degree", "8", "--complexity", "16"]) == 0
    for i in range(0, 24, 3):
        top = [json.loads(_json_search(cli, capsys, texts[i], "x"))[0]["id"]
               for cli in (ref_main, main)]
        assert top[0] == top[1] == f"docs/d{i}.md#0", top


def _same_npz(a, b, exact, close=()):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in exact:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in close:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _same_meta(workdir):
    metas = [json.loads((_index_dir(workdir, n) / "documents.leann.meta.json")
                        .read_text()) for n in ("a", "b")]
    assert metas[0] == metas[1]


def _twin_indexes(workdir, backend):
    """Index `a` built by the reference's CLI, `b` a byte copy of it."""
    _more_docs(workdir, 24)
    assert ref_main(["build", "a", "--docs", "docs", "--embedding-mode",
                     "fake", "--embedding-dimensions", "32",
                     "--backend-name", backend, "--graph-degree", "8",
                     "--complexity", "16"]) == 0
    shutil.copytree(_index_dir(workdir, "a"), _index_dir(workdir, "b"))


def test_update_graph_equals_reference(workdir, capsys):
    _twin_indexes(workdir, "hnsw")
    _more_docs(workdir, 12, prefix="e", seed=1)
    assert ref_main(["update", "a", "--docs", "docs"]) == 0
    assert main(["update", "b", "--docs", "docs"]) == 0
    _same_npz(*(_index_dir(workdir, n) / "documents.leann.graph.npz"
                for n in ("a", "b")), exact=("adjacency", "medoid", "metric"))
    _same_meta(workdir)


def test_update_ivf_equals_reference(workdir, capsys):
    """Both IVF branches: 2 new rows join their nearest fixed center
    (drift 2/29), then 12 more push the drift past 25% and retrain."""
    _twin_indexes(workdir, "ivf")
    files = [_index_dir(workdir, n) / "documents.leann.ivf.npz"
             for n in ("a", "b")]
    for count, prefix in ((2, "e"), (12, "f")):
        _more_docs(workdir, count, prefix=prefix, seed=count)
        capsys.readouterr()
        assert ref_main(["update", "a", "--docs", "docs"]) == 0
        ref_out = capsys.readouterr().out
        assert main(["update", "b", "--docs", "docs"]) == 0
        assert capsys.readouterr().out == ref_out
        _same_npz(*files, exact=("assign", "metric", "trained_n"),
                  close=("centers",))
    assert "retraining" in ref_out
    _same_meta(workdir)


def test_reindex_ivf_equals_reference(workdir, capsys):
    _twin_indexes(workdir, "flat")
    assert ref_main(["reindex", "a", "--backend-name", "ivf"]) == 0
    assert main(["reindex", "b", "--backend-name", "ivf"]) == 0
    _same_npz(*(_index_dir(workdir, n) / "documents.leann.ivf.npz"
                for n in ("a", "b")),
              exact=("assign", "metric", "trained_n"), close=("centers",))
    _same_meta(workdir)


SCORE = re.compile(r'"score": (-?[0-9.e+-]+)')


def test_search_json_equals_reference_on_flat(workdir, capsys):
    texts = _more_docs(workdir, 40)
    _build(workdir, name="fl")
    for q in texts[:8] + ["w1 w2 w3 w4 w5", "foxes and tensors"]:
        ref, got = (_json_search(cli, capsys, q, "fl") for cli in
                    (ref_main, main))
        assert SCORE.sub('"score": _', got) == SCORE.sub('"score": _', ref)
        np.testing.assert_allclose(
            [float(s) for s in SCORE.findall(got)],
            [float(s) for s in SCORE.findall(ref)], rtol=0, atol=1e-6)


@pytest.mark.parametrize("argv", [
    ["build", "nb", "--docs", "docs", "--embedding-mode", "fake",
     "--embedding-dimensions", "32"],
    ["search", "fox", "-i", "testidx"],
    ["update", "testidx", "--docs", "docs"],
    ["reindex", "testidx", "--backend-name", "ivf"],
    ["ask", "fox?", "-i", "testidx", "--llm", "simulated"],
    ["react", "fox?", "-i", "testidx", "--llm", "simulated"],
    ["serve", "testidx", "--port", "0"],
    ["mcp", "-i", "testidx"],
], ids=lambda a: a[0])
@pytest.mark.parametrize("device", ["--device cuda", "default"])
def test_cuda_without_cuda_fails_and_runs_nothing(
        workdir, capsys, monkeypatch, argv, device):
    """Without CUDA a command that reaches the device prints
    resolve_device's message and returns 1 before doing anything: no
    index is written or changed, nothing is printed on stdout. The
    default (no --device, LEANN_TORCH_DEVICE unset) is cuda."""
    import torch

    from leann_tpu_torch.device import resolve_device

    _build(workdir)
    before = {p: p.stat().st_mtime_ns
              for p in _index_dir(workdir, "testidx").iterdir()}
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device("cuda")
    if device == "default":
        monkeypatch.delenv("LEANN_TORCH_DEVICE")
        head = []
    else:
        head = device.split()
    assert main(head + argv) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.strip() == str(want.value)
    assert not _index_dir(workdir, "nb").exists()
    assert {p: p.stat().st_mtime_ns
            for p in _index_dir(workdir, "testidx").iterdir()} == before


def test_host_commands_need_no_device(workdir, capsys, monkeypatch):
    """list, config, remove and prune touch only files: they run without
    CUDA and without --device cpu."""
    import torch

    _build(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LEANN_TORCH_DEVICE")
    assert main(["list"]) == 0
    assert main(["config", "path"]) == 0
    assert main(["prune", "testidx", "-y"]) == 0
    assert main(["remove", "testidx", "-y"]) == 0
    assert not _index_dir(workdir, "testidx").exists()


def test_device_option_parses_one_device_or_a_list(monkeypatch):
    from leann_tpu_torch.cli.main import build_parser, primary_device

    monkeypatch.delenv("LEANN_TORCH_DEVICE", raising=False)
    assert build_parser().parse_args(["list"]).device is None
    monkeypatch.setenv("LEANN_TORCH_DEVICE", "cuda:1")
    assert build_parser().parse_args(["list"]).device == "cuda:1"
    args = build_parser().parse_args(["--device", "cpu, cpu,cpu", "list"])
    assert args.device == ["cpu"] * 3
    assert primary_device(args.device) == "cpu"
    assert build_parser().parse_args(["--device", "cpu", "list"]).device \
        == "cpu"


def test_port_cli_and_servers_import_no_jax(tmp_path):
    """A fresh interpreter: the port's CLI and servers build and search an
    index on the CPU, and sys.modules holds no jax* and no leann_tpu.*."""
    code = textwrap.dedent("""
        import io, json, os, sys
        from contextlib import redirect_stdout
        os.makedirs("docs")
        for i in range(6):
            with open(f"docs/f{i}.md", "w") as f:
                f.write(f"file number {i} about topic {i * 7}")
        from leann_tpu_torch.cli.main import main
        from leann_tpu_torch.cli import serve_cmd, mcp_cmd
        from leann_tpu_torch.server import batching, http, mcp
        from leann_tpu_torch.backend import usearch_import
        import leann_tpu_torch.__main__
        assert main(["build", "i", "--docs", "docs", "--embedding-mode",
                     "fake", "--embedding-dimensions", "128"]) == 0
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["search", "file number 3 about topic 21", "-i",
                         "i", "--format", "json", "--top-k", "1"]) == 0
        assert json.loads(buf.getvalue())[0]["id"] == "docs/f3.md#0"
        reply = mcp.McpServer("i", device="cpu").handle({
            "jsonrpc": "2.0", "id": 1, "method": "tools/call",
            "params": {"name": "search", "arguments": {
                "query": "file number 4 about topic 28", "top_k": 1}}})
        assert "docs/f4.md" in reply["result"]["content"][0]["text"]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m.startswith("jaxlib") or m == "leann_tpu"
                     or m.startswith("leann_tpu."))
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HOME=str(tmp_path / "home"), LEANN_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout
