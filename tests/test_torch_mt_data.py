"""The port's MT data pipeline against the JAX package's: ``get_dataset``
(the repository's corpus, its compositional split, the synthetic task),
the byte-level BPE against ``get_tokenizer`` (``tokenizers`` +
``transformers``), ``collate_batch``, and the C++ batch ring against the
Python collates.  Ids, vocabularies, merges and arrays are compared
exactly (tolerance 0)."""

import json
import unicodedata

import numpy as np
import pytest
import torch

from tpu_flash.data import mt as jmt
from tpu_flash_torch.data import bpe
from tpu_flash_torch.data import mt as tmt
from tpu_flash_torch.data import native_loader as tnl

torch.set_num_threads(1)

SPECIALS = ["<eos_de>", "<eos_en>", "<pad>"]


@pytest.mark.parametrize("name", ["local", "local-comp", "synthetic"])
def test_get_dataset_matches_jax(name):
    kw = {}
    if name == "synthetic":
        kw = dict(synthetic=True, n_train=300, n_validation=40, n_test=20)
    want = jmt.get_dataset("offline" if kw else name, 40, **kw)
    got = tmt.get_dataset(name, 40, **kw)
    assert got == want
    assert 0 < len(got[0]["test"]) <= 100 and len(got[0]["train"]) > 0


def test_get_dataset_refuses_other_names():
    with pytest.raises(ValueError, match="local, deen, local-deen, "
                                         "local-comp"):
        tmt.get_dataset("bbaaaa/iwslt14-de-en")


def test_local_corpus_file_is_the_jax_file():
    from tpu_flash.data import deen_corpus as jdc
    from tpu_flash_torch.data import deen_corpus as tdc
    with open(jdc.CORPUS_PATH, "rb") as a, open(tdc.CORPUS_PATH, "rb") as b:
        assert a.read() == b.read()
    assert tdc.build_pairs_keyed() == jdc.build_pairs_keyed()
    assert tdc.compositional_split() == jdc.compositional_split()


@pytest.fixture(scope="module")
def tokenizers_pair(tmp_path_factory):
    """Per corpus: (dataset, JAX tokenizer, its tokenizer.json, the port's
    tokenizer, its saved file)."""
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    out = {}
    for name, vocab in (("synthetic", 500), ("local", 10_000)):
        if name == "synthetic":
            ds = tmt.get_dataset("synthetic", 40, synthetic=True,
                                 n_train=300, n_validation=40, n_test=20)[0]
        else:
            ds = tmt.get_dataset("local", 40)[0]
        jdir = tmp_path_factory.mktemp(f"jax_{name}")
        tdir = tmp_path_factory.mktemp(f"port_{name}")
        jtok = jmt.get_tokenizer(ds["train"], vocab, "de", "en", str(jdir))
        ttok = tmt.get_tokenizer(ds["train"], vocab, "de", "en", str(tdir))
        out[name] = (ds, jtok, jdir / "tokenizer.json", ttok,
                     tdir / "tokenizer.json")
    return out


@pytest.mark.parametrize("name", ["synthetic", "local"])
def test_bpe_matches_jax_tokenizer(tokenizers_pair, name):
    ds, jtok, jfile, ttok, tfile = tokenizers_pair[name]
    model = json.loads(jfile.read_text())["model"]
    assert ttok.vocab == jtok.vocab == model["vocab"]
    assert [list(m) for m in ttok.merges] == model["merges"]
    assert len(ttok) == len(jtok)
    if name == "local":                      # the sizes the JAX app gets
        assert (len(ttok), len(ttok.merges)) == (1299, 1040)
    for t in SPECIALS:
        assert ttok.vocab[t] == SPECIALS.index(t)
    loaded = bpe.ByteLevelBPE.load(str(tfile))
    from tokenizers import Tokenizer
    hf = Tokenizer.from_file(str(tfile))
    for split in ds.values():
        for ex in split:
            for key in ("de", "en"):
                text = f"{ex[key]}<eos_{key}>"
                ids = ttok(text)["input_ids"]
                assert ids == jtok(text)["input_ids"], text
                assert ids == loaded(text)["input_ids"] == hf.encode(text).ids
                assert ttok.decode(ids) == jtok.decode(ids) == text
    odd = "Grüße, 3½ ü-é\t  x__y<eos_en> <pad>퟿"
    assert ttok(odd)["input_ids"] == jtok(odd)["input_ids"]
    # a lead byte without its continuation decodes to U+FFFD in both
    broken = [ttok.vocab[bpe.BYTE_TO_CHAR[0xC3]]] + ttok("ab")["input_ids"]
    assert ttok.decode(broken) == jtok.decode(broken) == "\ufffdab"


def test_pretokenizer_pattern_on_every_corpus_character():
    """``[^\\W\\d_]`` and ``\\d`` split every character of the repository's
    corpora as ``\\p{L}`` and ``\\p{N}`` do (the ``regex`` package, which
    the port may not use, stands for ``tokenizers``' pattern here)."""
    regex = pytest.importorskip("regex")
    gpt2 = regex.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                         r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
    texts = [ex[k] for name in ("local", "local-comp")
             for split in tmt.get_dataset(name, 10_000)[0].values()
             for ex in split for k in ("de", "en")]
    texts += [ex[k] for split in tmt.synthetic_translation_dataset(
        n_train=300, n_validation=40, n_test=20).values()
        for ex in split for k in ("de", "en")]
    chars = sorted({c for t in texts for c in t})
    for c in chars:
        for probe in (c, f"a{c}1 {c}{c}", f" {c}x"):
            assert bpe.PRETOKENIZE.findall(probe) == gpt2.findall(probe), c
    # the one class the pattern cannot say: numeric non-digits
    assert not [c for c in chars if unicodedata.category(c) in ("Nl", "No")]
    for text in texts:
        assert bpe.PRETOKENIZE.findall(text) == gpt2.findall(text)


@pytest.mark.parametrize("mask_padding", [False, True])
def test_collate_batch_matches_jax(tokenizers_pair, mask_padding):
    ds, jtok, _, ttok, _ = tokenizers_pair["local"]
    examples = ds["train"][:24] + ds["test"][:8]
    for L in (40, 12):                      # 12 cuts long examples
        want = jmt.collate_batch(examples, "de", "en", jtok, L,
                                 mask_padding=mask_padding)
        got = tmt.collate_batch(examples, "de", "en", ttok, L,
                                mask_padding=mask_padding)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype


def test_native_loader_matches_python_collates(tokenizers_pair):
    ds, _, _, tok, _ = tokenizers_pair["synthetic"]
    examples = ds["train"]
    flats = tnl.tokenize_corpus(examples, "de", "en", tok)
    pad = tok.vocab["<pad>"]
    idx = np.random.default_rng(0).permutation(len(examples))[:16]
    chosen = [examples[i] for i in idx]
    for L in (40, 16):
        for mask in (False, True):
            got = tnl.pack_batch(*flats, idx, L, pad, mask_padding=mask)
            want = tmt.collate_batch(chosen, "de", "en", tok, L,
                                     mask_padding=mask)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for rows in (3, 8):                 # 3 drops examples, 8 pads rows
            got = tnl.pack_batch_packed(*flats, idx, L, pad, rows)
            want = tmt.collate_packed(chosen, "de", "en", tok, L,
                                      fixed_rows=rows)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(IndexError):
        tnl.pack_batch(*flats, [len(examples)], 40, pad)
    loader = tnl.NativeBatchLoader(*flats, max_len=40, pad_id=pad,
                                   batch_size=8, seed=0, packed=True,
                                   fixed_rows=5)
    try:
        batches = [loader.next() for _ in range(3)]
    finally:
        loader.close()
    for b in batches:
        assert b["input_ids"].shape == (5, 40)
        assert set(b) == {"input_ids", "labels", "label_token_weights",
                          "segment_ids", "positions"}
