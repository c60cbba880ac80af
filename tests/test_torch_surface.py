"""The port's host surface against the reference's own tests and against
the reference on the same inputs: chunkers and the PDF loader
(`tests/test_chunker.py`), the model registry (`tests/test_registry.py`),
the HTTP embedding and LLM providers (`tests/test_providers_http.py`,
the same stub server on 127.0.0.1), RAG ask and the ReAct agent
(`tests/test_rag_agent.py`, the port on `device="cpu"`), and the config
file (`Config.to_toml` byte for byte).

Each case runs one body on `leann_tpu` and on `leann_tpu_torch`, keeps
the reference test's assertions on the port's result, and holds the two
results equal: chunks field for field, registry entries, provider
outputs and the requests they sent, retrieved ids. Scores of the RAG
cases within 1e-5 (both packages score the same f32 vectors)."""

import dataclasses
import importlib
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("leann_tpu", "leann_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn, *args):
    """fn(pkg, *args) for the reference and the port: (reference, port)."""
    return tuple(fn(pkg, *args) for pkg in PKGS)


# ------------------------------------------------------------- chunkers


def _chunks(chunks):
    return [(c.id, c.text, c.metadata) for c in chunks]


def _simple(pkg):
    return _mod(pkg, "chunker.simple").SimpleChunker


def _code(pkg):
    return _mod(pkg, "chunker.code").CodeChunker


def chunk_simple_short_text(pkg):
    chunks = _simple(pkg)(256, 128).chunk("hello world", "a.txt")
    assert len(chunks) == 1
    assert chunks[0].text == "hello world"
    assert chunks[0].metadata["chunk_type"] == "simple"
    assert chunks[0].metadata["source"] == "a.txt"
    return _chunks(chunks)


def chunk_simple_overlap_and_coverage(pkg):
    words = " ".join(f"word{i}" for i in range(2000))
    chunks = _simple(pkg)(64, 32).chunk(words, "a.txt")
    assert len(chunks) > 1
    for c in chunks:
        assert len(c.text) <= 64 * 4 + 1
    assert chunks[0].text.split()[-1] in chunks[1].text.split()
    assert "word1999" in chunks[-1].text
    return _chunks(chunks)


def chunk_simple_no_infinite_loop_on_long_token(pkg):
    chunks = _simple(pkg)(16, 8).chunk("x" * 5000, "a.txt")
    assert len(chunks) > 1
    assert sum(len(c.text) for c in chunks) >= 5000
    return _chunks(chunks)


def chunk_empty_text(pkg):
    chunks = _simple(pkg)().chunk("   ", "a.txt")
    assert chunks == []
    return _chunks(chunks)


RUST_SRC = """\
use std::io;

pub fn parse_input(s: &str) -> u32 {
    s.trim().parse().unwrap()
}

struct Config {
    value: u32,
}
"""

PY_SRC = """\
import os

class Greeter:
    def __init__(self, name):
        self.name = name

    def greet(self):
        return f"hi {self.name}"

def main():
    print(Greeter("x").greet())
"""


def chunk_code_chunker_rust_fn(pkg):
    chunks = _code(pkg)(256, 128).chunk(RUST_SRC, "main.rs")
    names = [c.metadata.get("name") for c in chunks
             if c.metadata.get("chunk_type") == "code"]
    assert "parse_input" in names and "Config" in names
    fn = next(c for c in chunks if c.metadata.get("name") == "parse_input")
    assert "s.trim().parse()" in fn.text
    assert fn.metadata["language"] == "rust"
    assert any(c.metadata.get("chunk_type") == "context" for c in chunks)
    return _chunks(chunks)


def chunk_code_chunker_python_class(pkg):
    chunks = _code(pkg)(256, 128).chunk(PY_SRC, "app.py")
    code = [c for c in chunks if c.metadata.get("chunk_type") == "code"]
    names = [c.metadata.get("name") for c in code]
    assert "Greeter" in names and "main" in names
    cls = next(c for c in code if c.metadata["name"] == "Greeter")
    assert "def greet" in cls.text
    return _chunks(chunks)


def chunk_code_chunker_fallback_unknown_lang(pkg):
    chunks = _code(pkg)().chunk("plain text " * 50, "notes.xyz")
    assert all(c.metadata["chunk_type"] == "simple" for c in chunks)
    return _chunks(chunks)


def chunk_smart_chunker_routing(pkg):
    ch = _mod(pkg, "chunker")
    smart = ch.SmartChunker(strategy=ch.ChunkingStrategy.AUTO)
    code_chunks = smart.chunk("def f():\n    return 1\n", "a.py")
    assert any(c.metadata.get("chunk_type") == "code" for c in code_chunks)
    text_chunks = smart.chunk("just some text", "a.md")
    assert all(c.metadata["chunk_type"] == "simple" for c in text_chunks)
    return _chunks(code_chunks) + _chunks(text_chunks)


def chunk_strategy_parse(pkg):
    strat = _mod(pkg, "chunker").ChunkingStrategy
    assert strat.parse("ast") == strat.AST
    assert strat.parse("AUTO") == strat.AUTO
    with pytest.raises(ValueError) as exc:
        strat.parse("bogus")
    return [strat.parse(s).value for s in ("ast", "AUTO", " simple ")] + [
        str(exc.value)]


def chunk_oversize_block_split(pkg):
    body = "\n".join(f"    x{i} = {i}" for i in range(400))
    chunks = _code(pkg)(64, 16).chunk(f"def big():\n{body}\n", "big.py")
    code = [c for c in chunks if c.metadata.get("chunk_type") == "code"]
    assert len(code) > 1
    assert all(c.metadata["name"] == "big" for c in code)
    return _chunks(chunks)


def _make_pdf(path, page_texts, compress=True):
    """A minimal single-font PDF with one content stream per page (the
    reference test's writer)."""
    import zlib

    objs = []
    page_ids = [4 + 2 * i for i in range(len(page_texts))]
    kids = " ".join(f"{pid} 0 R" for pid in page_ids)
    objs.append(b"<< /Type /Catalog /Pages 2 0 R >>")
    objs.append(
        f"<< /Type /Pages /Kids [{kids}] /Count {len(page_texts)} >>".encode())
    objs.append(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    for i, text in enumerate(page_texts):
        esc = text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        content = f"BT /F1 12 Tf 72 720 Td ({esc}) Tj ET".encode("latin-1")
        filt = b""
        if compress:
            content = zlib.compress(content)
            filt = b"/Filter /FlateDecode "
        objs.append(
            f"<< /Type /Page /Parent 2 0 R /Contents {page_ids[i] + 1} 0 R "
            f"/Resources << /Font << /F1 3 0 R >> >> >>".encode())
        objs.append(b"<< " + filt + f"/Length {len(content)} >>\nstream\n"
                    .encode() + content + b"\nendstream")
    out = bytearray(b"%PDF-1.4\n")
    offsets = [0]
    for i, obj in enumerate(objs, start=1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref_at = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    for off in offsets[1:]:
        out += f"{off:010d} 00000 n \n".encode()
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref_at}\n%%EOF\n").encode()
    with open(path, "wb") as f:
        f.write(bytes(out))


def chunk_pdf_text_extraction_flate(pkg, tmp_path):
    p = tmp_path / "doc.pdf"
    _make_pdf(str(p), ["Hello TPU world (with parens)", "Second page text"])
    text = _mod(pkg, "utils.pdftext").extract_pdf_text(str(p))
    assert "Hello TPU world (with parens)" in text
    assert "Second page text" in text
    return text


def chunk_pdf_text_extraction_uncompressed_and_tj_array(pkg, tmp_path):
    p = tmp_path / "doc.pdf"
    _make_pdf(str(p), ["plain stream body"], compress=False)
    text = _mod(pkg, "utils.pdftext").extract_pdf_text(str(p))
    assert "plain stream body" in text
    return text


def chunk_load_file_content_reads_pdf(pkg, tmp_path):
    p = tmp_path / "notes.pdf"
    _make_pdf(str(p), ["bm25 ranking inside a pdf"])
    text = _mod(pkg, "cli.common").load_file_content(str(p))
    assert text is not None and "bm25 ranking inside a pdf" in text
    return text


def chunk_load_file_content_pdf_no_text(pkg, tmp_path):
    p = tmp_path / "empty.pdf"
    p.write_bytes(b"%PDF-1.4\nnothing here\n%%EOF\n")
    text = _mod(pkg, "cli.common").load_file_content(str(p))
    assert text is None
    return text


CHUNK_CASES = [
    chunk_simple_short_text, chunk_simple_overlap_and_coverage,
    chunk_simple_no_infinite_loop_on_long_token, chunk_empty_text,
    chunk_code_chunker_rust_fn, chunk_code_chunker_python_class,
    chunk_code_chunker_fallback_unknown_lang, chunk_smart_chunker_routing,
    chunk_strategy_parse, chunk_oversize_block_split,
]
PDF_CASES = [
    chunk_pdf_text_extraction_flate,
    chunk_pdf_text_extraction_uncompressed_and_tj_array,
    chunk_load_file_content_reads_pdf, chunk_load_file_content_pdf_no_text,
]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda f: f.__name__[6:])
def test_chunker_matches_reference(case):
    want, got = _both(case)
    assert got == want


@pytest.mark.parametrize("case", PDF_CASES, ids=lambda f: f.__name__[6:])
def test_pdf_loading_matches_reference(case, tmp_path, monkeypatch):
    """`load_file_content` tries pypdf first: with it hidden, both
    packages take their own pure-Python extractor whether or not pypdf
    is installed."""
    monkeypatch.setitem(sys.modules, "pypdf", None)
    want, got = _both(case, tmp_path)
    assert got == want


# ------------------------------------------------------------- registry


REGISTRY_CASES = {
    "nomic": (["nomic-embed-text"], lambda c: (
        c[0].document_prefix == "search_document: "
        and c[0].query_prefix == "search_query: " and c[0].normalized
        and c[0].dimensions == 768)),
    "version_tag_stripped": (["nomic-embed-text:latest"], lambda c: (
        c[0].document_prefix == "search_document: ")),
    "mxbai": (["mxbai-embed-large"], lambda c: (
        c[0].dimensions == 1024 and c[0].query_prefix != "")),
    "bge_query_only_prefix": (
        ["bge-base-en-v1.5", "bge-small-en", "bge-large-en"], lambda c: (
            c[0].document_prefix == ""
            and "searching relevant passages" in c[0].query_prefix
            and c[1].dimensions == 384 and c[2].dimensions == 1024)),
    "e5": (["e5-base-v2", "multilingual-e5-large"], lambda c: (
        c[0].document_prefix == "passage: " and c[0].query_prefix == "query: "
        and c[1].dimensions == 1024)),
    "openai_dims": (
        ["text-embedding-3-small", "text-embedding-3-large",
         "text-embedding-ada-002"],
        lambda c: [x.dimensions for x in c] == [1536, 3072, 1536]),
    "unknown_defaults": (["some-unknown-model"], lambda c: (
        c[0].document_prefix == "" and c[0].query_prefix == ""
        and not c[0].normalized and c[0].dimensions == 768)),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_matches_reference(case):
    names, check = REGISTRY_CASES[case]
    want, got = _both(lambda pkg: [
        _mod(pkg, "embed.registry").get_model_config(n) for n in names])
    assert check(got)
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


# ------------------------------------------------------------- HTTP providers


class MockApi(BaseHTTPRequestHandler):
    """The reference test's stub: OpenAI, Ollama and Gemini routes."""

    calls = []
    fail_next = 0
    fail_code = 503

    def log_message(self, *a):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        MockApi.calls.append((self.path, body))
        if MockApi.fail_next > 0:
            MockApi.fail_next -= 1
            payload = json.dumps(
                {"error": {"message": "temporarily overloaded"}}).encode()
            self.send_response(MockApi.fail_code)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        if self.path == "/v1/embeddings":
            resp = {"data": [
                {"index": i, "embedding": [float(len(t)), 1.0, 2.0]}
                for i, t in enumerate(body["input"])]}
        elif self.path == "/api/embed":
            resp = {"embeddings": [[1.0, 2.0] for _ in body["input"]]}
        elif self.path == "/v1/chat/completions":
            resp = {"choices": [{"message": {
                "content": f"echo: {body['messages'][0]['content'][:20]}"}}]}
        elif self.path == "/api/generate":
            resp = {"response": f"gen: {body['prompt'][:10]}", "done": True}
        elif ":batchEmbedContents" in self.path:
            resp = {"embeddings": [
                {"values": [float(len(r["content"]["parts"][0]["text"])),
                            3.0, 4.0]}
                for r in body["requests"]]}
        else:
            self.send_response(404)
            self.end_headers()
            return
        payload = json.dumps(resp).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@pytest.fixture()
def mock_api():
    MockApi.calls = []
    MockApi.fail_next = 0
    MockApi.fail_code = 503
    server = ThreadingHTTPServer(("127.0.0.1", 0), MockApi)
    t = threading.Thread(target=server.serve_forever, args=(0.05,),
                         daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def http_openai_embedding_batches_of_100(pkg, url, monkeypatch):
    p = _mod(pkg, "embed.openai").OpenAIEmbedding(
        model="text-embedding-3-small", api_key="k", base_url=url + "/v1")
    out = p.embed([f"t{i}" for i in range(250)])
    assert out.shape == (250, 3)
    calls = [c for c in MockApi.calls if c[0] == "/v1/embeddings"]
    assert [len(c[1]["input"]) for c in calls] == [100, 100, 50]
    return out.tolist()


def http_openai_dim_probe_for_unknown_model(pkg, url, monkeypatch):
    p = _mod(pkg, "embed.openai").OpenAIEmbedding(
        model="custom-model", api_key="k", base_url=url + "/v1")
    assert p.dimensions == 3
    return p.dimensions


def http_ollama_embedding_batches_of_32(pkg, url, monkeypatch):
    p = _mod(pkg, "embed.ollama").OllamaEmbedding(
        model="nomic-embed-text", host=url)
    out = p.embed([f"x{i}" for i in range(70)])
    assert out.shape == (70, 2)
    calls = [c for c in MockApi.calls if c[0] == "/api/embed"]
    assert [len(c[1]["input"]) for c in calls] == [32, 32, 6]
    return out.tolist()


def http_retry_on_503_then_success(pkg, url, monkeypatch):
    """Two 503s, then the answer; the backoff's sleeps are recorded
    instead of slept (1 s, then 2 s)."""
    httpx = _mod(pkg, "embed.httpx")
    slept = []
    monkeypatch.setattr(httpx.time, "sleep", slept.append)
    MockApi.fail_next = 2
    resp = httpx.post_json(url + "/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "hello"}]})
    assert "echo" in resp["choices"][0]["message"]["content"]
    assert len(MockApi.calls) == 3
    assert slept == [1.0, 2.0]
    return resp


def http_no_retry_on_400_and_error_extraction(pkg, url, monkeypatch):
    httpx = _mod(pkg, "embed.httpx")
    MockApi.fail_next = 1
    MockApi.fail_code = 400
    with pytest.raises(httpx.HttpError) as exc:
        httpx.post_json(url + "/v1/chat/completions", {"messages": []})
    assert "temporarily overloaded" in str(exc.value)
    assert len(MockApi.calls) == 1
    return (exc.value.status, str(exc.value))


def http_openai_llm(pkg, url, monkeypatch):
    llm = _mod(pkg, "llm.openai").OpenAILlm(
        model="gpt-x", api_key="k", base_url=url + "/v1")
    out = llm.generate("what is up")
    assert out.startswith("echo:")
    return out


def http_ollama_llm_parses_single_json(pkg, url, monkeypatch):
    llm = _mod(pkg, "llm.ollama").OllamaLlm(model="m", host=url)
    out = llm.generate("hello world")
    assert out.startswith("gen:")
    return out


def http_lmstudio_mode_routes_to_openai_compatible(pkg, url, monkeypatch):
    p = _mod(pkg, "embed").EmbeddingProvider(
        mode="lmstudio", model="text-embedding-3-small",
        base_url=url + "/v1", api_key="k")
    assert p.mode == "openai"
    out = p.embed(["ab"])
    assert out.shape == (1, 3)
    return out.tolist()


def http_gemini_embedding_batches_of_100(pkg, url, monkeypatch):
    p = _mod(pkg, "embed.gemini").GeminiEmbedding(
        model="text-embedding-004", api_key="gk", base_url=url + "/v1beta")
    vecs = p.embed([f"t{i:03d}" for i in range(150)])
    assert vecs.shape == (150, 3)
    calls = [c for c in MockApi.calls if ":batchEmbedContents" in c[0]]
    assert [len(c[1]["requests"]) for c in calls] == [100, 50]
    assert all("key=gk" in c[0] for c in calls)
    assert all("/models/text-embedding-004:" in c[0] for c in calls)
    assert p.dimensions == 3
    assert vecs[0][0] == 4.0
    return vecs.tolist()


def http_gemini_env_key_resolution(pkg, url, monkeypatch):
    monkeypatch.delenv("GOOGLE_API_KEY", raising=False)
    monkeypatch.setenv("GEMINI_API_KEY", "envkey")
    p = _mod(pkg, "embed.gemini").GeminiEmbedding(base_url=url + "/v1beta")
    p.embed(["hello"])
    call = [c for c in MockApi.calls if ":batchEmbedContents" in c[0]][-1]
    assert "key=envkey" in call[0]
    return call[0]


HTTP_CASES = [
    http_openai_embedding_batches_of_100,
    http_openai_dim_probe_for_unknown_model,
    http_ollama_embedding_batches_of_32, http_retry_on_503_then_success,
    http_no_retry_on_400_and_error_extraction, http_openai_llm,
    http_ollama_llm_parses_single_json,
    http_lmstudio_mode_routes_to_openai_compatible,
    http_gemini_embedding_batches_of_100, http_gemini_env_key_resolution,
]


@pytest.mark.parametrize("case", HTTP_CASES, ids=lambda f: f.__name__[5:])
def test_http_provider_matches_reference(case, mock_api, monkeypatch):
    """Each package against its own fresh stub state: the same result
    and the same requests (paths and bodies), apart from the port."""
    out = {}
    for pkg in PKGS:
        MockApi.calls = []
        MockApi.fail_next = 0
        MockApi.fail_code = 503
        result = case(pkg, mock_api, monkeypatch)
        out[pkg] = (result, list(MockApi.calls))
    assert out["leann_tpu_torch"] == out["leann_tpu"]


# ------------------------------------------------------------- RAG and agent


RAG_TEXTS = [
    "the capital of France is Paris",
    "TPUs have a systolic matrix unit",
    "BM25 is a ranking function",
]


@pytest.fixture(scope="module")
def rag_pair(tmp_path_factory):
    """The reference test's three-passage index, built once by the
    reference; both packages search it (the port on the CPU)."""
    from leann_tpu.index.builder import IndexBuilder

    base = str(tmp_path_factory.mktemp("rag") / "test" / "documents.leann")
    ref_provider = _mod("leann_tpu", "embed").EmbeddingProvider(
        mode="fake", dimensions=16)
    builder = IndexBuilder(base, dim=16)
    for i, (t, v) in enumerate(zip(RAG_TEXTS, ref_provider.embed(RAG_TEXTS))):
        builder.add(f"t{i}", t, v)
    builder.build()
    ref = (_mod("leann_tpu", "index.searcher").IndexSearcher.load(base),
           ref_provider)
    port = (_mod("leann_tpu_torch", "index.searcher").IndexSearcher.load(
        base, device="cpu"),
        _mod("leann_tpu_torch", "embed").EmbeddingProvider(
            mode="fake", dimensions=16))
    return {"leann_tpu": ref, "leann_tpu_torch": port}


def _llm(pkg):
    return _mod(pkg, "llm").LlmProvider(mode="simulated")


def rag_parse_action_search(pkg, idx):
    a = _mod(pkg, "agent.react").parse_action(
        "Thought: hmm\nAction: search(vector databases)")
    assert a.kind == "search" and a.arg == "vector databases"
    return (a.kind, a.arg), []


def rag_parse_action_finish_multiline(pkg, idx):
    a = _mod(pkg, "agent.react").parse_action(
        "Thought: done\nAction: finish(The answer\nis 42.)")
    assert a.kind == "finish" and "42" in a.arg
    return (a.kind, a.arg), []


def rag_parse_action_missing_close_paren(pkg, idx):
    a = _mod(pkg, "agent.react").parse_action("Action: finish(no close paren")
    assert a.kind == "finish" and a.arg == "no close paren"
    return (a.kind, a.arg), []


def rag_parse_action_none(pkg, idx):
    a = _mod(pkg, "agent.react").parse_action("I refuse to follow the format")
    assert a is None
    return a, []


def rag_simulated_llm_modes(pkg, idx):
    llm = _llm(pkg)
    first = llm.generate("Question: x\nContext: y")
    assert "simulated" in first.lower()
    second = llm.generate("Thought: ...\nAction: ...")
    assert "Action:" in second
    return (first, second, llm.model), []


def _hits(results):
    return [(r.id, r.text, r.metadata) for r in results]


def _scores(results):
    return [r.score for r in results]


def rag_ask_session(pkg, idx):
    searcher, provider = idx[pkg]
    session = _mod(pkg, "rag.ask").AskSession(searcher, provider, _llm(pkg),
                                              top_k=2)
    result = session.ask("What is the capital of France?")
    assert result.answer
    assert len(result.sources) == 2
    assert result.sources[0].id == "t0"
    return (result.answer, _hits(result.sources)), _scores(result.sources)


def rag_build_prompt_numbers_passages(pkg, idx):
    searcher, provider = idx[pkg]
    rag = _mod(pkg, "rag.ask")
    passages = rag.AskSession(searcher, provider, _llm(pkg)).retrieve(
        "TPUs have a systolic matrix unit")
    prompt = rag.build_prompt("what is a TPU?", passages)
    assert "[1]" in prompt
    assert "Question: what is a TPU?" in prompt
    return (prompt, _hits(passages)), _scores(passages)


def rag_react_agent_completes(pkg, idx):
    searcher, provider = idx[pkg]
    agent = _mod(pkg, "agent.react").ReActAgent(
        searcher, provider, _llm(pkg), max_steps=4)
    answer, steps = agent.run("what ranks documents?")
    assert answer
    assert len(steps) >= 2
    assert steps[0].observation
    return (answer, [(s.thought_action, s.observation) for s in steps]), []


def rag_react_agent_search_observation_contains_snippets(pkg, idx):
    searcher, provider = idx[pkg]
    agent = _mod(pkg, "agent.react").ReActAgent(searcher, provider,
                                                _llm(pkg), top_k=2)
    obs = agent.execute_search("BM25 is a ranking function")
    assert "[1]" in obs and "(t2)" in obs
    return obs, []


RAG_CASES = [
    rag_parse_action_search, rag_parse_action_finish_multiline,
    rag_parse_action_missing_close_paren, rag_parse_action_none,
    rag_simulated_llm_modes, rag_ask_session,
    rag_build_prompt_numbers_passages, rag_react_agent_completes,
    rag_react_agent_search_observation_contains_snippets,
]


@pytest.mark.parametrize("case", RAG_CASES, ids=lambda f: f.__name__[4:])
def test_rag_agent_matches_reference(case, rag_pair):
    """Each case returns (its result, the scores of the hits it got)."""
    (want, want_sc), (got, got_sc) = _both(case, rag_pair)
    assert got == want
    np.testing.assert_allclose(got_sc, want_sc, rtol=0, atol=1e-5)


# ------------------------------------------------------------- config


def _full_config(pkg):
    cfg_mod = _mod(pkg, "config")
    cfg = cfg_mod.Config()
    cfg.embedding.provider = "openai"
    cfg.embedding.model = "text-embedding-3-small"
    cfg.embedding.base_url = "http://localhost:1234/v1"
    cfg.embedding.api_key = "sk-test"
    cfg.embedding.batch_size = 50
    cfg.build.chunk_size = 512
    cfg.build.file_types = ["rs", "py", "md"]
    cfg.build.exclude_types = ["json"]
    return cfg


@pytest.mark.parametrize("which", ["default", "full"])
def test_config_toml_bytes_match_reference(which, tmp_path, monkeypatch):
    """`to_toml` gives the reference's bytes; `save` writes them under
    XDG_CONFIG_HOME and `load` reads back the same fields in both
    packages, each reading the other's file."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    make = ((lambda pkg: _mod(pkg, "config").Config()) if which == "default"
            else _full_config)
    want, got = _both(make)
    assert got.to_toml().encode() == want.to_toml().encode()
    path = got.save()
    assert path == str(tmp_path / "xdg" / "leann" / "config.toml")
    assert open(path, "rb").read() == want.to_toml().encode()
    back = _both(lambda pkg: _mod(pkg, "config").Config.load())
    assert [dataclasses.asdict(c) for c in back] == \
        [dataclasses.asdict(want)] * 2
    assert _mod("leann_tpu_torch", "config").EXAMPLE_CONFIG == \
        _mod("leann_tpu", "config").EXAMPLE_CONFIG
