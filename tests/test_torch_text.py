"""The port's local text encoders (``afford_motion_torch/models/text.py``,
``text_towers.py``, ``tokenizers.py``, ``utils/hf_weights.py``) against the
JAX package's, which run ``transformers`` on the same directories.

Tiny seeded towers (2 layers, width 32, toy vocabularies) are built once for
the module with ``transformers``' ``save_pretrained`` in a temporary
directory: a text-only CLIP (first-EOS pooling, ``quick_gelu``), one with the
legacy ``eos_token_id`` 2 (argmax pooling, ``gelu``), a whole ``CLIPModel``,
a BERT in ``model.safetensors`` and the same in ``pytorch_model.bin``, a
``BertForPreTraining`` (``bert.`` keys, ``cls.*`` heads) and a
``BertForMaskedLM`` (no pooler). ``transformers`` is imported only here,
inside the fixture: its import is the file's largest cost.

Tolerance: ``TOL`` (1e-5) of the largest entry. Both sides compute in float32;
``transformers`` runs ``sdpa`` attention where the port runs the eager
formula, so the last bits differ.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from afford_motion_tpu.models import text as jax_text
from afford_motion_tpu.models.conditioning import host_prepare_cond as jax_host_prepare_cond
from afford_motion_torch.data.synthetic import (
    make_synthetic_bert_dir,
    make_synthetic_clip_dir,
    make_synthetic_h3d,
    synthetic_bert_vocab,
    synthetic_clip_vocab,
)
from afford_motion_torch.models import text
from afford_motion_torch.models.conditioning import host_prepare_cond
from afford_motion_torch.models.tokenizers import BertTokenizer, ClipTokenizer
from afford_motion_torch.utils.hf_weights import read_safetensors, write_safetensors
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
WIDTH = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4)
CLIP_VOCAB, BERT_VOCAB = 1200, 600
LONG = " ".join(["a person walks forward slowly and then turns left"] * 8)
# pieces the captions' accented, Greek, CJK and digit words need in the toy
# BERT vocabulary, so that a wrong normalization shows as another piece
BERT_EXTRA = ["οδοσ", "οδος", "ς", "##ς", "σ", "##σ", "cafe", "café", "naive", "naïve",
              "resume", "résumé", "istanbul", "i̇stanbul", "##̇", "i", "##stanbul", "coöperation",
              "cooperation", "一", "个", "人", "走", "路", "坐", "下", "手", "²", "½", "ⅻ", "Ⅻ",
              "٣", "ß", "é", "e", "##́", "🙂", "emoji", "Someone", "STROLLS", "ΟΔΟΣ", "##s"]
CAPTIONS = [
    "a person walks forward",
    "", "   ",
    "Someone STROLLS ahead, then sits down.",
    "Café naïve résumé: the man's coöperation",
    "一个人走路 then 坐下 with 手",
    "walks 3 steps, turns 180 degrees; ² ½ Ⅻ ٣",
    "he's, they're, we'll, I'd, you've, I'm, it'ſ, don't, ''s, 'S",
    "wow!!! ... ?! -- (jump) [kick] {wave} #1 @ $ % ^ & * ~ ` |",
    "ΟΔΟΣ İstanbul é ß",
    "tab\there\nnew line\x00nul\ufffdbad\u200bzw\x07bell\u2028sep\xa0nbsp\x85end",
    "[CLS] a <|endoftext|> b [SEP] <|startoftext|>c[MASK]",
    "🙂 emoji and " + "x" * 120,
    LONG,
]


def _perturb(model, seed):
    """Every parameter moved by seeded N(0, 0.02) noise: biases and
    LayerNorms away from their 0 / 1 initial values."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    # transformers would import TensorFlow, which nothing here uses
    os.environ.setdefault("USE_TF", "0")
    from transformers import (BertConfig, BertForMaskedLM, BertForPreTraining, BertModel,
                              BertTokenizer as HFBert, CLIPConfig, CLIPModel, CLIPTextConfig,
                              CLIPTextModelWithProjection, CLIPTokenizer as HFClip)

    root = tmp_path_factory.mktemp("text_towers")
    vocab, merges = synthetic_clip_vocab(CLIP_VOCAB, seed=1)
    (root / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                     encoding="utf-8")
    (root / "vocab.txt").write_text(
        "\n".join(synthetic_bert_vocab(BERT_VOCAB, seed=1) + BERT_EXTRA) + "\n", encoding="utf-8")
    clip_tok = HFClip(str(root / "vocab.json"), str(root / "merges.txt"))
    out = {"clip_noheader": root / "clip_noheader"}
    # a merges.txt without its "#version" line: the first merge is skipped
    clip_tok.save_pretrained(out["clip_noheader"])
    (out["clip_noheader"] / "merges.txt").write_text("\n".join(merges) + "\n", encoding="utf-8")
    for name, kw in (("clip", {}), ("clip_legacy", {"eos_token_id": 2, "hidden_act": "gelu"})):
        cfg = CLIPTextConfig(vocab_size=CLIP_VOCAB, max_position_embeddings=77, projection_dim=16,
                             bos_token_id=CLIP_VOCAB - 2, **{"eos_token_id": CLIP_VOCAB - 1,
                                                             **WIDTH, **kw})
        torch.manual_seed(0)
        _perturb(CLIPTextModelWithProjection(cfg), 1).save_pretrained(root / name)
        clip_tok.save_pretrained(root / name)
        out[name] = root / name
    # a whole CLIPModel whose text half is "clip"'s
    text_cfg = json.loads((root / "clip" / "config.json").read_text())
    full = CLIPModel(CLIPConfig(
        text_config={k: v for k, v in text_cfg.items() if k not in ("architectures", "dtype")},
        vision_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                           num_attention_heads=2, image_size=32, patch_size=16),
        projection_dim=16))
    state = CLIPTextModelWithProjection.from_pretrained(root / "clip").state_dict()
    full.load_state_dict(state, strict=False)
    full.save_pretrained(root / "clip_full")
    clip_tok.save_pretrained(root / "clip_full")
    out["clip_full"] = root / "clip_full"

    bert_tok = HFBert(str(root / "vocab.txt"))
    bert_cfg = BertConfig(vocab_size=BERT_VOCAB + len(BERT_EXTRA), max_position_embeddings=64,
                          **WIDTH)
    torch.manual_seed(2)
    bert = _perturb(BertModel(bert_cfg), 3)
    for name, model, safe in (("bert", bert, True), ("bert_bin", bert, False),
                              ("bert_prefixed", _perturb(BertForPreTraining(bert_cfg), 4), False),
                              ("bert_nopool", _perturb(BertForMaskedLM(bert_cfg), 5), True)):
        model.save_pretrained(root / name, safe_serialization=safe)
        bert_tok.save_pretrained(root / name)
        out[name] = root / name
    # the same vocabulary under the other tokenizer settings
    for name, kw in (("bert_cased", {"do_lower_case": False}),
                     ("bert_keep_accents", {"strip_accents": False}),
                     ("bert_strip_cased", {"do_lower_case": False, "strip_accents": True,
                                           "tokenize_chinese_chars": False})):
        HFBert(str(root / "vocab.txt"), **kw).save_pretrained(root / name)
        out[name] = root / name
    return out


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


# ------------------------------------------------------------------ tokenizers
@pytest.mark.parametrize("name", ["clip", "clip_noheader"])
@pytest.mark.parametrize("max_length", [6, 32])
def test_clip_ids_equal_the_slow_tokenizer(dirs, name, max_length):
    """Token strings and the padded ids of ``CLIPTokenizer`` (no ``ftfy``),
    padded as the JAX encoder pads them: ``min(max_length + 2, 77)`` then
    zeros to 77."""
    from transformers import CLIPTokenizer

    hf, port = CLIPTokenizer.from_pretrained(dirs[name]), ClipTokenizer(dirs[name])
    for caption in CAPTIONS:
        assert port.tokenize(caption) == hf.tokenize(caption), caption
    m = min(max_length + 2, 77)
    tok = hf(CAPTIONS, padding="max_length", truncation=True, max_length=m)
    want_ids = np.zeros((len(CAPTIONS), 77), dtype=np.int64)
    want_mask = np.zeros_like(want_ids)
    want_ids[:, :m], want_mask[:, :m] = tok["input_ids"], tok["attention_mask"]
    ids, mask = port(CAPTIONS, max_length)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("name", ["bert", "bert_cased", "bert_keep_accents", "bert_strip_cased"])
@pytest.mark.parametrize("max_length", [8, 32])
def test_bert_ids_equal_the_slow_tokenizer(dirs, name, max_length):
    """Token strings, ids and masks of the slow ``BertTokenizer`` under each
    ``tokenizer_config.json`` setting, ``[CLS] ... [SEP]`` truncated and
    ``[PAD]``-padded to ``max_length``."""
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(dirs[name], use_fast=False)
    port = BertTokenizer(dirs[name])
    for caption in CAPTIONS:
        assert port.tokenize(caption) == hf.tokenize(caption), caption
    tok = hf(CAPTIONS, padding="max_length", truncation=True, max_length=max_length)
    ids, mask = port(CAPTIONS, max_length)
    np.testing.assert_array_equal(ids, np.asarray(tok["input_ids"]))
    np.testing.assert_array_equal(mask, np.asarray(tok["attention_mask"]))


def test_wordpiece_unknowns_and_the_longest_match():
    """Greedy longest match with ``##`` continuations; a word the vocabulary
    cannot cover, or longer than 100 characters, is one ``[UNK]``."""
    tok = BertTokenizer.__new__(BertTokenizer)
    tok.vocab = {t: i for i, t in enumerate(["[UNK]", "un", "##aff", "##able", "a", "##a"])}
    tok.specials = {"unk_token": "[UNK]"}
    assert tok.wordpiece("unaffable") == ["un", "##aff", "##able"]
    assert tok.wordpiece("unaffablez") == ["[UNK]"]
    assert tok.wordpiece("a" * 100) == ["a"] + ["##a"] * 99
    assert tok.wordpiece("a" * 101) == ["[UNK]"]


# ------------------------------------------------------------------ weights
def test_safetensors_round_trip_and_the_package(dirs, tmp_path):
    """The reader against the ``safetensors`` package on a file
    ``transformers`` wrote, and the writer's file read back by both, every
    dtype the reader takes."""
    from safetensors.torch import load_file

    want = load_file(dirs["bert"] / "model.safetensors")
    got = read_safetensors(dirs["bert"] / "model.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.f32": torch.randn(3, 5, generator=gen),
               "b.f16": torch.randn(7, generator=gen).half(),
               "c.bf16": torch.randn(2, 3, 4, generator=gen).bfloat16(),
               "d.i64": torch.arange(6).reshape(2, 3), "e.i32": torch.arange(4, dtype=torch.int32),
               "f.scalar": torch.tensor(1.5), "g.empty": torch.zeros(0, 4)}
    write_safetensors(tmp_path / "t.safetensors", tensors)
    for reader in (read_safetensors, load_file):
        back = reader(tmp_path / "t.safetensors")
        assert sorted(back) == sorted(tensors)
        for k, v in tensors.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((tmp_path / "t.safetensors").read_bytes()[:-8])
    with pytest.raises(ValueError, match="do not fit"):
        read_safetensors(bad)


# ------------------------------------------------------------------ towers
@pytest.mark.parametrize("name", ["clip", "clip_legacy", "clip_full"])
def test_clip_tower_matches_jax(dirs, name):
    """Pooled, projected CLIP embeddings (first-EOS and argmax pooling,
    ``quick_gelu`` and ``gelu``, a text-only and a whole-``CLIPModel``
    directory) against the JAX package's ``ClipTextEncoder``."""
    jenc = jax_text.ClipTextEncoder(str(dirs[name]), max_length=6)
    enc = text.ClipTextEncoder(str(dirs[name]), max_length=6, device="cpu")
    assert enc.dim == jenc.dim == 16
    _close(enc.encode(CAPTIONS), jenc.encode(CAPTIONS), name)
    if name == "clip_full":
        same = text.ClipTextEncoder(str(dirs["clip"]), max_length=6, device="cpu")
        np.testing.assert_array_equal(same.encode(CAPTIONS), enc.encode(CAPTIONS))


@pytest.mark.parametrize("name", ["bert", "bert_bin", "bert_prefixed"])
def test_bert_tower_matches_jax(dirs, name):
    """Pooled BERT and per-token BERT with its pad mask against the JAX
    package's ``BertTextEncoder``: ``model.safetensors``, the same weights in
    ``pytorch_model.bin`` (bit-equal to it here), and a
    ``BertForPreTraining`` file (``bert.`` keys, ``cls.*`` heads)."""
    pooled = text.BertTextEncoder(str(dirs[name]), max_length=10, device="cpu")
    _close(pooled.encode(CAPTIONS),
           jax_text.BertTextEncoder(str(dirs[name]), max_length=10).encode(CAPTIONS), name)
    tokens = text.BertTextEncoder(str(dirs[name]), max_length=10, pooled=False, device="cpu")
    jtokens = jax_text.BertTextEncoder(str(dirs[name]), max_length=10, pooled=False)
    (emb, pad), (jemb, jpad) = tokens.encode_tokens(CAPTIONS), jtokens.encode_tokens(CAPTIONS)
    np.testing.assert_array_equal(pad, jpad)
    assert emb.shape == (len(CAPTIONS), 10, 32) and pad.dtype == bool
    _close(emb, jemb, name + " per-token")
    if name == "bert_bin":
        ref = text.BertTextEncoder(str(dirs["bert"]), max_length=10, device="cpu")
        np.testing.assert_array_equal(pooled.encode(CAPTIONS), ref.encode(CAPTIONS))


def test_bert_without_a_pooler(dirs):
    """A ``BertForMaskedLM`` file holds no ``pooler.*``. ``transformers``
    draws a random pooler there, and the JAX encoder returns its output
    (pinned); the port's pooled encoder raises. The per-token features need
    no pooler and agree."""
    jax_pooled = jax_text.BertTextEncoder(str(dirs["bert_nopool"]), max_length=10)
    assert np.isfinite(jax_pooled.encode(CAPTIONS[:2])).all()
    with pytest.raises(ValueError, match="no pooler"):
        text.BertTextEncoder(str(dirs["bert_nopool"]), max_length=10, device="cpu")
    tokens = text.BertTextEncoder(str(dirs["bert_nopool"]), max_length=10, pooled=False,
                                  device="cpu")
    jtokens = jax_text.BertTextEncoder(str(dirs["bert_nopool"]), max_length=10, pooled=False)
    _close(tokens.encode_tokens(CAPTIONS)[0], jtokens.encode_tokens(CAPTIONS)[0], "no pooler")
    with pytest.raises(ValueError, match="no pooler"):
        tokens.encode(CAPTIONS[:1])


def test_synthetic_directories_load_in_transformers(tmp_path):
    """``data/synthetic.py``'s seeded directories (the port's safetensors
    writer, the synthetic vocabularies; what ``chip_smoke.py`` writes at the
    published widths) load in ``transformers`` and agree with the port."""
    clip_cfg = dict(model_type="clip_text_model", vocab_size=900,
                    max_position_embeddings=77, hidden_act="quick_gelu", layer_norm_eps=1e-5,
                    projection_dim=16, bos_token_id=898, eos_token_id=899, **WIDTH)
    bert_cfg = dict(model_type="bert", vocab_size=500, max_position_embeddings=64,
                    type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12, **WIDTH)
    make_synthetic_clip_dir(str(tmp_path / "clip"), clip_cfg, seed=3)
    make_synthetic_bert_dir(str(tmp_path / "bert"), bert_cfg, seed=3)
    caps = CAPTIONS[:6]
    _close(text.ClipTextEncoder(str(tmp_path / "clip"), max_length=20, device="cpu").encode(caps),
           jax_text.ClipTextEncoder(str(tmp_path / "clip"), max_length=20).encode(caps), "clip")
    emb, pad = text.BertTextEncoder(str(tmp_path / "bert"), max_length=12, pooled=False,
                                    device="cpu").encode_tokens(caps)
    jemb, jpad = jax_text.BertTextEncoder(str(tmp_path / "bert"), max_length=12,
                                          pooled=False).encode_tokens(caps)
    np.testing.assert_array_equal(pad, jpad)
    _close(emb, jemb, "bert")


def test_batching_does_not_change_an_embedding(dirs):
    """A caption alone equals the same caption in a mixed call bit for bit
    (chunks of ``ENCODE_CHUNK`` padded with ""), across a chunk boundary
    too; the memo cache answers the second call without the tower."""
    many = [f"a person walks {i} steps" for i in range(text.ENCODE_CHUNK + 5)]
    for name, per_token in (("clip", False), ("bert", False), ("bert", True)):
        kind = text.ClipTextEncoder if name == "clip" else text.BertTextEncoder
        kw = {"pooled": not per_token} if name == "bert" else {}
        mixed, alone = (kind(str(dirs[name]), max_length=10, device="cpu", **kw)
                        for _ in range(2))
        fn = mixed.encode_tokens if per_token else mixed.encode
        got = fn(many + CAPTIONS)
        for i in (0, text.ENCODE_CHUNK + 2, len(many) + 3):
            caption = (many + CAPTIONS)[i]
            one = (alone.encode_tokens if per_token else alone.encode)([caption])
            for a, b in zip(got if per_token else (got,), one if per_token else (one,)):
                np.testing.assert_array_equal(a[i], b[0])
        mixed.model = None  # a cache miss would raise
        again = fn(many[:3] + many[:3])
        for a, b in zip(again if per_token else (again,), got if per_token else (got,)):
            np.testing.assert_array_equal(a[:3], b[:3])
            np.testing.assert_array_equal(a[3:], b[:3])


# ------------------------------------------------------------------ provider choice
def _table(path: Path, dim: int) -> str:
    np.savez(path, texts=np.array(CAPTIONS[:4]),
             embeddings=np.arange(4 * dim, dtype=np.float32).reshape(4, dim))
    return str(path)


def _outcome(fn):
    try:
        return type(fn()).__name__
    except (FileNotFoundError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("family", ["clip", "bert"])
@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("weights", [True, False])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("per_token", [True, False])
def test_provider_choice_equals_jax(dirs, tmp_path, family, table, weights, strict, per_token):
    """``create_text_encoder`` picks the JAX package's provider, or raises
    the same error, for each family with the table and the weights present or
    absent, strict or not, pooled or per-token."""
    version = "ViT-B/32" if family == "clip" else "bert-base-uncased"
    kw = dict(table_path=_table(tmp_path / "t.npz", 16 if family == "clip" else 32)
              if table else str(tmp_path / "none.npz"),
              weights_dir=str(dirs[family]) if weights else str(tmp_path / "none"),
              max_length=10, strict_table=strict, per_token=per_token)
    got = _outcome(lambda: text.create_text_encoder(version, device="cpu", **kw))
    want = _outcome(lambda: jax_text.create_text_encoder(version, **kw))
    assert got == want
    if got.endswith("Encoder") and got != "HashTextEncoder":
        enc = text.create_text_encoder(version, device="cpu", **kw)
        jenc = jax_text.create_text_encoder(version, **kw)
        assert enc.per_token == jenc.per_token and enc.dim == jenc.dim


def test_unusable_weights_raise_where_jax_hashes(dirs, tmp_path):
    """A CLIP weights directory that exists but cannot be loaded: the JAX
    package logs a warning and hashes (pinned); the port raises, naming the
    file. An empty directory lacks ``config.json``; one without weights
    names both weight files; one without ``merges.txt`` names it."""
    (tmp_path / "empty").mkdir()
    assert type(jax_text.create_text_encoder(
        "ViT-B/32", weights_dir=str(tmp_path / "empty"))).__name__ == "HashTextEncoder"
    with pytest.raises(FileNotFoundError, match="config.json"):
        text.create_text_encoder("ViT-B/32", weights_dir=str(tmp_path / "empty"), device="cpu")
    no_weights = tmp_path / "no_weights"
    no_weights.mkdir()
    (no_weights / "config.json").write_text((dirs["clip"] / "config.json").read_text())
    with pytest.raises(FileNotFoundError, match="model.safetensors nor pytorch_model.bin"):
        text.create_text_encoder("ViT-B/32", weights_dir=str(no_weights), device="cpu")
    no_merges = tmp_path / "no_merges"
    no_merges.mkdir()
    for f in ("config.json", "model.safetensors", "vocab.json"):
        (no_merges / f).write_bytes((dirs["clip"] / f).read_bytes())
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        text.create_text_encoder("ViT-B/32", weights_dir=str(no_merges), device="cpu")
    with pytest.raises(ValueError, match="model_type 'bert', not 'clip'"):
        text.create_text_encoder("ViT-B/32", weights_dir=str(dirs["bert"]), device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        text.create_text_encoder("bert-base-uncased", weights_dir=str(tmp_path / "empty"),
                                 device="cpu")


@pytest.mark.parametrize("family", ["clip", "bert_pooled", "bert_tokens"])
def test_host_prepare_cond_matches_jax(dirs, family):
    """``text_emb`` (and ``text_token_mask`` from per-token BERT) of
    ``host_prepare_cond`` against the JAX package's, the other arrays equal."""
    rng = np.random.default_rng(3)
    batch = {"x": rng.normal(size=(4, 6, 5)).astype(np.float32),
             "c_text_mask": np.array([True, False, True, False]),
             "c_text": CAPTIONS[:4], "info_index": ["a", "b", "c", "d"]}
    version = "ViT-B/32" if family == "clip" else "bert-base-uncased"
    kw = dict(weights_dir=str(dirs["clip" if family == "clip" else "bert"]), max_length=10,
              per_token=family == "bert_tokens")
    (x, cond), (jx, jcond) = (host_prepare_cond(batch, text.create_text_encoder(
        version, device="cpu", **kw)), jax_host_prepare_cond(batch, jax_text.create_text_encoder(
            version, **kw)))
    np.testing.assert_array_equal(x, jx)
    assert sorted(cond) == sorted(jcond)
    for k in cond:
        if k == "text_emb":
            _close(cond[k], jcond[k], k)
        else:
            np.testing.assert_array_equal(cond[k], jcond[k], err_msg=k)
    assert cond["text_emb"].dtype == np.float32


# ------------------------------------------------------------------ entries
def _bert768(tmp_path_factory) -> Path:
    """A one-layer BERT 768 wide (the CMDM's BERT text width), written by
    the port's synthetic writer."""
    path = tmp_path_factory.mktemp("bert768") / "bert"
    make_synthetic_bert_dir(str(path), dict(
        model_type="bert", vocab_size=400, hidden_size=768, num_hidden_layers=1,
        num_attention_heads=12, intermediate_size=64, max_position_embeddings=32,
        type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12), seed=5)
    return path


def test_train_entry_runs_per_token_bert(tmp_path_factory, monkeypatch):
    """The CMDM trains through ``afford_motion_torch.train`` on the CPU with
    a BERT weights directory: per-token features of
    ``model.text_model.max_length`` (20) tokens from the tower, finite
    losses."""
    from afford_motion_torch import train as train_pkg
    from afford_motion_torch.train import entry

    root = tmp_path_factory.mktemp("bert_train")
    make_synthetic_h3d(str(root / "data"), n_items=8, num_points=256, horizon_range=(40, 60))
    bert = _bert768(tmp_path_factory)
    made = []

    def spy(*args, **kwargs):
        made.append(text.create_text_encoder(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(entry, "create_text_encoder", spy)
    monkeypatch.chdir(REPO)
    out = train_pkg.main([
        "task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
        "model.data_repr=h3d", "diffusion.steps=1000", f"task.dataset.data_dir={root}/data",
        f"exp_dir={root}/exp", "task.dataset.num_points=256", "model.latent_dim=32",
        "model.time_emb_dim=32", "model.num_heads=4", "model.dim_feedforward=64",
        "model.num_layers=[1]", "model.contact_model.planes=[8,16,32,64]",
        "model.dtype=float32", "task.train.batch_size=2", "task.train.max_steps=2",
        "task.train.save_every_step=2", "task.train.log_every_step=1", "platform=jsonl",
        "model.text_model.version=bert-base-uncased", "model.text_model.max_length=20",
        f"text_encoder.table_path={root}/none", f"text_encoder.weights_dir={bert}",
        "device=cpu"])
    assert out["step"] == 2 and all(np.isfinite(e["loss"]) for e in out["logged"])
    (enc,) = made
    assert isinstance(enc, text.BertTextEncoder) and enc.per_token and enc.max_length == 20
    assert enc._tok_cache and all(e.shape == (20, 768) for e, _ in enc._tok_cache.values())


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["train", "test", "sample"])
def test_entries_pass_max_length_and_device(entry, monkeypatch, tmp_path):
    """Each entry hands ``model.text_model.max_length`` and its device to
    ``create_text_encoder`` (the dataset and the model are stubbed: the
    call is what is under test)."""
    from afford_motion_torch import sample, test as test_entry
    from afford_motion_torch.train import entry as train_entry

    module = {"train": train_entry, "test": test_entry, "sample": sample}[entry]
    seen = {}

    class Data:
        def __len__(self):
            return 4

        def get_dataloader(self, **kw):
            return []

    def stop(version, **kw):
        seen.update(kw, version=version)
        raise _Stop

    monkeypatch.setattr(module, "create_dataset", lambda *a, **k: Data())
    monkeypatch.setattr(module, "create_model_and_diffusion", lambda *a, **k: (None, None))
    monkeypatch.setattr(module, "create_text_encoder", stop)
    monkeypatch.chdir(REPO)
    task = {"train": "text_to_motion_contact_motion_gen", "test": "text_to_motion_contact_motion_gen",
            "sample": "contact_motion_gen"}[entry]
    with pytest.raises(_Stop):
        module.main([f"task={task}", "model=cmdm", "model.text_model.max_length=20",
                     f"exp_dir={tmp_path}", "platform=jsonl"], device="cpu")
    assert seen["max_length"] == 20 and str(seen["device"]) == "cpu"
    assert seen["per_token"] and seen["version"] == "ViT-B/32"


# ------------------------------------------------------------------ the export tool
def test_export_tool_writes_the_live_encoders_table(dirs, tmp_path):
    """``afford_motion_torch.tools.export_text_embeddings`` collects the
    tree's captions (with ``""``) and writes the live encoder's embeddings,
    which the table provider then serves."""
    from afford_motion_torch.tools import export_text_embeddings as export

    data = tmp_path / "data"
    make_synthetic_h3d(str(data), n_items=4, num_points=64, horizon_range=(40, 50))
    (data / "H3D" / "texts" / "extra.txt").write_text(
        "\n".join(f"{c}#x/NOUN#0.0#0.0" for c in CAPTIONS[3:8] if "#" not in c) + "\n")
    out = tmp_path / "table.npz"
    export.main(["--data_dir", str(data), "--out", str(out), "--weights_dir",
                 str(dirs["clip"]), "--max_length", "20", "--device", "cpu"])
    z = np.load(out)
    captions = [str(t) for t in z["texts"]]
    assert captions == export.collect_captions(str(data)) and "" in captions
    assert "a person walks forward" in captions and CAPTIONS[3] in captions
    live = text.ClipTextEncoder(str(dirs["clip"]), max_length=20, device="cpu")
    np.testing.assert_array_equal(z["embeddings"], live.encode(captions))
    table = text.create_text_encoder("ViT-B/32", table_path=str(out), device="cpu")
    np.testing.assert_array_equal(table.encode(captions[:3]), live.encode(captions[:3]))


# ------------------------------------------------------------------ imports
def test_towers_import_no_transformers(dirs):
    """Both towers load and encode on the CPU in a fresh process with none
    of ``transformers``, ``safetensors``, ``regex``, ``ftfy``, jax or the JAX
    package loaded."""
    code = (
        "import sys\n"
        "from afford_motion_torch.models.text import create_text_encoder\n"
        f"c = create_text_encoder('ViT-B/32', weights_dir={str(dirs['clip'])!r}, device='cpu')\n"
        f"b = create_text_encoder('bert-base-uncased', weights_dir={str(dirs['bert_prefixed'])!r},"
        " per_token=True, device='cpu')\n"
        "assert c.encode(['a person walks']).shape == (1, 16)\n"
        "assert b.encode_tokens(['a person walks'])[0].shape == (1, 32, 32)\n"
        "import afford_motion_torch.tools.export_text_embeddings\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('transformers', 'safetensors', 'regex', 'ftfy', 'jax', 'jaxlib', 'flax',\n"
        "              'afford_motion_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
