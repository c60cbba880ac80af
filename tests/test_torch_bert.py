"""Parity of the port's BERT encoder (`leann_tpu_torch/models/bert.py`,
`models/fixture.py`, `embed/local.py`) with the JAX reference
(`leann_tpu/models/bert.py`), on the CPU.

Tolerances:
- `init_params`, the tokenizers, `tokenize_corpus`, the fixture files:
  equal;
- `bert_forward` on weights carried across, compute_dtype float32: atol
  1e-5 on unit-norm embeddings (float32 sums in another order);
- compute_dtype bfloat16: atol 2e-3 (both round the operands of each
  product to bf16 and keep float32 sums; a float32 value that lands near
  a bf16 rounding boundary may round the other way in one of the two,
  which moves a pooled component by up to ~1e-3), and cosine >= 0.999
  against the float32 run;
- `BertEncoder.embed`: the same tolerances through the batch and length
  buckets."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_tpu.models import bert as jbert
from leann_tpu.models.fixture import write_bert_fixture as jwrite_fixture
from leann_tpu_torch.embed import LocalEmbedding
from leann_tpu_torch.models import bert as tbert
from leann_tpu_torch.models.fixture import write_bert_fixture

torch.set_num_threads(1)

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "hello world",
    "building a vector index of documents for search, testing embeddings!",
    "tokens embedding models?? layers -- pruned graphs",
]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _tokens(cfg, b=6, t=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (b, t)).astype(np.int32)
    lens = [t, 1, 7, t - 3, 0, 12][:b]          # ragged; row 4 all padding
    mask = (np.arange(t)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


def _both(cfg_kw, ids, mask, seed=0):
    jcfg = dataclasses.replace(jbert.BertConfig.tiny(), **cfg_kw)
    tcfg = dataclasses.replace(tbert.BertConfig.tiny(), **cfg_kw)
    weights = jbert.init_params(jcfg, seed)
    want = np.asarray(jbert.bert_forward(
        weights, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    params = tbert.params_from_reference(weights, device="cpu")
    with torch.no_grad():
        got = tbert.bert_forward(params, torch.from_numpy(ids),
                                 torch.from_numpy(mask), tcfg).numpy()
    return got, want


@pytest.mark.parametrize("cfg", ["tiny", "default"])
def test_config_and_init_params_equal(cfg):
    if cfg == "tiny":
        jcfg, tcfg = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    else:
        # the published bert-base widths are the defaults; draw a cut
        jcfg = jbert.BertConfig(num_layers=1, vocab_size=500)
        tcfg = tbert.BertConfig(num_layers=1, vocab_size=500)
        assert (tbert.BertConfig().hidden_size, tbert.BertConfig().num_layers,
                tbert.BertConfig().intermediate_size,
                tbert.BertConfig().vocab_size) == (768, 12, 3072, 30522)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    want = dict(_flat(jbert.init_params(jcfg, 3)))
    got = dict(_flat(tbert.init_params(tcfg, 3)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_params_from_reference_carries_every_array():
    weights = jbert.init_params(jbert.BertConfig.tiny(), 1)
    params = tbert.params_from_reference(weights, device="cpu")
    assert isinstance(params, torch.nn.Module)
    n = sum(a.size for _, a in _flat(weights))
    assert sum(p.numel() for p in params.parameters()) == n
    assert not any(p.requires_grad for p in params.parameters())
    np.testing.assert_array_equal(
        params.layers[1]["ffn_in_kernel"].numpy(),
        weights["layers"][1]["ffn_in"]["kernel"])          # [in, out]
    assert params.layers[1]["ffn_in_kernel"].shape == (64, 128)


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_forward_f32_matches_reference(act):
    ids, mask = _tokens(tbert.BertConfig.tiny())
    got, want = _both(dict(compute_dtype="float32", hidden_act=act), ids, mask)
    assert got.shape == want.shape == (6, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got[:4], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh"])
def test_forward_bf16_matches_reference(act):
    ids, mask = _tokens(tbert.BertConfig.tiny(), seed=1)
    got, want = _both(dict(hidden_act=act), ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    f32, _ = _both(dict(compute_dtype="float32", hidden_act=act), ids, mask)
    live = mask.sum(1) > 0
    assert ((got * f32).sum(1)[live] > 0.999).all()


def test_gelu_variants_differ_and_unnormalized_output():
    ids, mask = _tokens(tbert.BertConfig.tiny(), seed=2)
    a, _ = _both(dict(compute_dtype="float32"), ids, mask)
    b, _ = _both(dict(compute_dtype="float32", hidden_act="gelu_new"), ids,
                 mask)
    assert not np.allclose(a, b, rtol=1e-6, atol=1e-7)
    got, want = _both(dict(compute_dtype="float32", normalize_output=False),
                      ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.abs(np.linalg.norm(got, axis=1) - 1.0).max() > 1e-2


def test_hash_tokenizer_and_tokenize_corpus_equal():
    texts = TEXTS + ["", "Ünïcode Wörds and  spaces", " ".join(["w"] * 300)]
    for vocab, max_len in ((1024, 128), (30522, 16)):
        got = tbert.HashTokenizer(vocab, max_len).encode_batch(texts)
        want = jbert.HashTokenizer(vocab, max_len).encode_batch(texts)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jenc = jbert.BertEncoder(config=jbert.BertConfig.tiny())
    tenc = tbert.BertEncoder(config=tbert.BertConfig.tiny(), device="cpu")
    for max_length in (None, 32, 4):
        for a, b in zip(tenc.tokenize_corpus(texts, max_length),
                        jenc.tokenize_corpus(texts, max_length)):
            np.testing.assert_array_equal(a, b)


def test_buckets_equal():
    for t in (1, 15, 16, 17, 100, 511, 512, 600):
        for cap in (128, 256, 512):
            assert tbert._bucket_len(t, cap=cap) == jbert._bucket_len(t, cap=cap)
    for b in (1, 7, 8, 9, 128, 129):
        assert tbert._bucket_batch(b) == jbert._bucket_batch(b)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_encoder_embed_across_buckets(dtype, atol):
    """13 texts at batch 5: batches of 5, 5 and 3 (batch bucket 8), with
    lengths in the 16 and 32 buckets and one past max_length."""
    words = "alpha beta gamma delta epsilon zeta eta theta".split()
    texts = [" ".join(words[: 1 + i % 8] * (1 + i // 5)) for i in range(12)]
    texts.append(" ".join(words * 9))
    jenc = jbert.BertEncoder(config=jbert.BertConfig.tiny(), max_length=64,
                             compute_dtype=dtype)
    tenc = tbert.BertEncoder(config=tbert.BertConfig.tiny(), max_length=64,
                             compute_dtype=dtype, device="cpu")
    got, want = tenc.embed(texts, batch_size=5), jenc.embed(texts, batch_size=5)
    assert got.shape == want.shape == (13, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert tenc.embed([]).shape == (0, 64)
    assert tenc.dimensions == 64


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return write_bert_fixture(str(tmp_path_factory.mktemp("bert_fixture")))


def test_fixture_files_equal_reference(ckpt_dir, tmp_path):
    ref = jwrite_fixture(str(tmp_path / "ref"))
    assert sorted(os.listdir(ckpt_dir)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        with open(os.path.join(ref, name), "rb") as a, \
                open(os.path.join(ckpt_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_load_hf_params_matches_reference_loader(ckpt_dir):
    jcfg = jbert.BertConfig.from_hf_config(os.path.join(ckpt_dir, "config.json"))
    tcfg = tbert.BertConfig.from_hf_config(os.path.join(ckpt_dir, "config.json"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    want = dict(_flat(jbert.load_hf_params(ckpt_dir, jcfg)))
    got = dict(_flat(tbert.load_hf_params(ckpt_dir, tcfg)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_hf_tokenizer_and_checkpoint_encoder_match_reference(ckpt_dir):
    pytest.importorskip("transformers")
    for a, b in zip(tbert.HfTokenizer(ckpt_dir, 128).encode_batch(TEXTS),
                    jbert.HfTokenizer(ckpt_dir, 128).encode_batch(TEXTS)):
        np.testing.assert_array_equal(a, b)
    jenc = jbert.BertEncoder(model_dir=ckpt_dir, compute_dtype="float32")
    tenc = tbert.BertEncoder(model_dir=ckpt_dir, compute_dtype="float32",
                             device="cpu")
    assert isinstance(tenc.tokenizer, tbert.HfTokenizer)
    np.testing.assert_allclose(tenc.embed(TEXTS), jenc.embed(TEXTS), rtol=0,
                               atol=1e-5)


def test_encoder_refuses_a_hub_name_and_a_broken_checkpoint(tmp_path):
    with pytest.raises(RuntimeError, match="not a local checkpoint directory"):
        tbert.BertEncoder(model_dir="bert-base-uncased", device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(RuntimeError, match="failed to load model weights"):
        tbert.BertEncoder(model_dir=str(empty), device="cpu")


def test_local_embedding_dimensions_and_output():
    from leann_tpu.embed.local import LocalEmbedding as JaxLocalEmbedding

    emb = LocalEmbedding(device="cpu")
    ref = JaxLocalEmbedding()
    assert emb.dimensions == ref.dimensions == 64
    assert emb.model == ref.model == "local-tiny"
    got, want = emb.embed(TEXTS), ref.embed(TEXTS)
    assert got.shape == (4, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    enc = tbert.BertEncoder(config=tbert.BertConfig.tiny(), seed=5,
                            device="cpu")
    assert LocalEmbedding(encoder=enc, batch_size=2).encoder is enc
