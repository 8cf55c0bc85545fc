"""Machine-translation data, counterpart of ``tpu_flash/data/mt.py``: the
corpora (``get_dataset``: the repository's German-English corpus, its
compositional split, and the deterministic synthetic translation task),
the byte-level BPE (``get_tokenizer``, the port's own ``data/bpe.py``),
the fixed-length collate (``collate_batch``) and the sequence-packed one
(``collate_packed``), numpy code kept here as the port's own copy (the port
imports nothing of the JAX package).

A tokenizer is duck-typed: ``tok(text)["input_ids"]`` gives a list of ids
and ``tok.vocab["<pad>"]`` the pad id.  ``WordTokenizer`` is a stand-in of
that shape, one id per word of a corpus.

One deviation: the JAX ``get_dataset`` tries a HuggingFace download for any
other name and falls back to the synthetic task; the port reads only the
corpora in the repository and raises a ``ValueError`` for any other name,
so that it never trains on the synthetic task when a corpus was asked for.
"""

from __future__ import annotations

import os
import re

import numpy as np

from tpu_flash_torch.data.bpe import ByteLevelBPE

SRC_KEY, TGT_KEY = "de", "en"
LOCAL_CORPORA = ("local", "deen", "local-deen", "local-comp")


class WordTokenizer:
    """A stand-in for the BPE tokenizer, duck-typed as ``collate_packed``
    takes it: one id per word of ``examples`` (dicts of texts) after the pad
    and end-of-sentence specials."""

    def __init__(self, examples):
        words = sorted({w for ex in examples for t in ex.values()
                        for w in t.split()})
        specials = ["<pad>", f"<eos_{SRC_KEY}>", f"<eos_{TGT_KEY}>"]
        self.vocab = {w: i for i, w in enumerate(specials + words)}

    def __call__(self, text):
        return {"input_ids": [self.vocab[t] for t in
                              re.findall(r"<eos_\w+>|[^\s<]+", text)]}


def _synthetic_lexicon(n_words: int, seed: int):
    """Bijective pseudo-word lexicon: src word i <-> tgt word perm[i]."""
    rng = np.random.default_rng(seed)
    syll_a = ["ka", "mo", "ri", "ze", "lu", "ta", "ven", "dor", "shi", "gal"]
    syll_b = ["na", "pel", "vi", "ruk", "so", "em", "ba", "tli", "our", "ke"]
    src_words, tgt_words = [], []
    for i in range(n_words):
        a, b, c = i % 10, (i // 10) % 10, i // 100
        src_words.append(f"{syll_a[a]}{syll_b[b]}{syll_a[c % 10]}")
        tgt_words.append(f"{syll_b[a]}{syll_a[b]}{syll_b[c % 10]}")
    perm = rng.permutation(n_words)
    return src_words, tgt_words, perm


def synthetic_translation_dataset(
    n_train: int = 20_000,
    n_validation: int = 1_000,
    n_test: int = 100,
    n_words: int = 400,
    min_len: int = 3,
    max_len: int = 12,
    seed: int = 0,
) -> dict[str, list[dict[str, str]]]:
    """Deterministic offline translation corpus: the target is the
    lexicon-mapped source words in reversed order, so a model must learn
    both a vocabulary mapping and a reordering rule."""
    src_words, tgt_words, perm = _synthetic_lexicon(n_words, seed)

    def make(n, salt):
        local = np.random.default_rng(seed + 2 + salt)
        out = []
        for _ in range(n):
            ln = int(local.integers(min_len, max_len + 1))
            ids = local.integers(0, n_words, ln)
            src = " ".join(src_words[i] for i in ids)
            tgt = " ".join(tgt_words[perm[i]] for i in ids[::-1])
            out.append({SRC_KEY: src, TGT_KEY: tgt})
        return out

    return {
        "train": make(n_train, 0),
        "validation": make(n_validation, 1),
        "test": make(n_test, 2),
    }


def _filtered(dataset, model_max_length: int):
    """Pairs of fewer than ``model_max_length`` words in all, and at most
    100 test examples: the reference's protocol."""
    dataset = {
        split: [ex for ex in dataset[split]
                if len(ex[SRC_KEY].split()) + len(ex[TGT_KEY].split())
                < model_max_length]
        for split in dataset
    }
    dataset["test"] = dataset["test"][:100]
    return dataset


def get_dataset(dataset_name: str = "local", model_max_length: int = 40,
                synthetic: bool | None = None, **synthetic_kwargs):
    """``(dataset, src_key, tgt_key)``, each split a list of ``{"de": ...,
    "en": ...}`` (JAX ``data/mt.py:85-144``).  ``"local"`` (or ``"deen"``,
    ``"local-deen"``) is the repository's corpus (``data/deen_corpus.py``),
    ``"local-comp"`` its compositional split; ``synthetic=True`` the
    synthetic task whatever the name (``synthetic_kwargs`` go to it; the
    JAX function takes a local name first, but its CLI's default name is a
    download, so that there ``--synthetic`` alone means the synthetic
    task, as it does here).  Any other name raises (module docstring)."""
    if synthetic:
        dataset = synthetic_translation_dataset(**synthetic_kwargs)
    elif dataset_name in LOCAL_CORPORA:
        from tpu_flash_torch.data import deen_corpus

        dataset = (deen_corpus.compositional_split()
                   if dataset_name == "local-comp"
                   else deen_corpus.load_dataset())
    else:
        raise ValueError(
            f"dataset {dataset_name!r} is not in the repository: the port "
            f"reads {', '.join(LOCAL_CORPORA)} or synthetic=True "
            f"(--synthetic)")
    return _filtered(dataset, model_max_length), SRC_KEY, TGT_KEY


def get_tokenizer(examples, vocab_size: int, src_key: str, tgt_key: str,
                  workdir: str, save: bool = True) -> ByteLevelBPE:
    """A byte-level BPE trained on the pairs of ``examples`` with the
    ``<eos_src>``, ``<eos_tgt>`` and ``<pad>`` specials (ids 0, 1, 2),
    saved to ``workdir/tokenizer.json`` (JAX ``data/mt.py:151-172``);
    ``save=False`` (a rank other than 0) trains the same one and writes
    nothing."""
    tokenizer = ByteLevelBPE.train_from_iterator(
        [[ex[src_key], ex[tgt_key]] for ex in examples], vocab_size,
        special_tokens=[f"<eos_{src_key}>", f"<eos_{tgt_key}>", "<pad>"])
    if save:
        os.makedirs(workdir, exist_ok=True)
        tokenizer.save(os.path.join(workdir, "tokenizer.json"))
    return tokenizer


def collate_batch(
    examples,
    src_key: str,
    tgt_key: str,
    tokenizer,
    model_max_length: int,
    mask_padding: bool = False,
) -> dict[str, np.ndarray]:
    """``src + <eos_src> + tgt + <eos_tgt> + pads`` at a fixed length, with
    next-token labels and the source's label weights 0 (JAX ``data/mt.py:
    178-216``).  ``mask_padding=False`` keeps the pads after the target at
    weight 1, as the reference does; True gives them 0."""
    pad_id = tokenizer.vocab["<pad>"]
    n = len(examples)
    L = model_max_length
    input_ids = np.full((n, L), pad_id, np.int32)
    labels = np.full((n, L), pad_id, np.int32)
    weights = np.ones((n, L), np.float32)
    for r, ex in enumerate(examples):
        ids_src = tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
        ids_tgt = tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"]
        ids = (ids_src + ids_tgt)[:L]
        input_ids[r, :len(ids)] = ids
        labels[r, :len(ids) - 1] = ids[1:]
        weights[r, :min(L, len(ids_src) - 1)] = 0.0
        if mask_padding:
            weights[r, len(ids):] = 0.0
    return {
        "input_ids": input_ids,
        "labels": labels,
        "label_token_weights": weights,
    }


def collate_packed(
    examples,
    src_key: str,
    tgt_key: str,
    tokenizer,
    row_length: int,
    max_rows: int | None = None,
    fixed_rows: int | None = None,
    drop_counter: list | None = None,
) -> dict[str, np.ndarray]:
    """Sequence-packed collation: greedily fills ``row_length``-token rows
    with whole ``src + <eos_src> + tgt + <eos_tgt>`` examples and emits
    ``segment_ids`` / ``positions`` so that attention and position
    embeddings stay per example (``ops.flash_attention``'s
    ``segment_ids``).  Only the tail of a row is padded, as one more
    segment.  Labels are next tokens inside each segment; the source part
    and each example's last position weigh 0.

    Returns input_ids / labels / label_token_weights / segment_ids /
    positions, all ``[rows, row_length]``.  Examples longer than
    ``row_length`` are cut to it.  ``fixed_rows`` pads (with all-pad,
    zero-weight rows) or trims the batch to that many rows; examples in
    trimmed rows are dropped and counted into ``drop_counter`` when given."""
    pad_id = tokenizer.vocab["<pad>"]
    rows = []            # each: list of (ids, n_src) tuples
    cur, cur_len = [], 0
    for ex in examples:
        ids_src = tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
        ids_tgt = tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"]
        ids = (ids_src + ids_tgt)[:row_length]
        if cur_len + len(ids) > row_length:
            rows.append(cur)
            cur, cur_len = [], 0
            if max_rows is not None and len(rows) >= max_rows:
                break
        cur.append((ids, len(ids_src)))
        cur_len += len(ids)
    if cur and (max_rows is None or len(rows) < max_rows):
        rows.append(cur)
    if fixed_rows is not None:
        if drop_counter is not None:
            drop_counter.append(sum(len(r) for r in rows[fixed_rows:]))
        rows = rows[:fixed_rows]
        while len(rows) < fixed_rows:
            rows.append([])               # all-pad row, zero loss weight

    n = len(rows)
    input_ids = np.full((n, row_length), pad_id, np.int32)
    labels = np.full((n, row_length), pad_id, np.int32)
    weights = np.zeros((n, row_length), np.float32)
    segment_ids = np.zeros((n, row_length), np.int32)
    positions = np.zeros((n, row_length), np.int32)
    for r, row in enumerate(rows):
        off = 0
        for sid, (ids, n_src) in enumerate(row):
            ln = len(ids)
            input_ids[r, off:off + ln] = ids
            labels[r, off:off + ln - 1] = ids[1:]
            weights[r, off:off + ln] = 1.0
            weights[r, off:off + min(ln, n_src - 1)] = 0.0
            weights[r, off + ln - 1] = 0.0   # last position predicts nothing
            segment_ids[r, off:off + ln] = sid
            positions[r, off:off + ln] = np.arange(ln)
            off += ln
        segment_ids[r, off:] = len(row)      # pad-tail segment
        positions[r, off:] = np.arange(row_length - off)
    return {
        "input_ids": input_ids,
        "labels": labels,
        "label_token_weights": weights,
        "segment_ids": segment_ids,
        "positions": positions,
    }
