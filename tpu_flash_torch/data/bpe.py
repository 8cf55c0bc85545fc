"""Byte-level BPE, the port's own: what the JAX package's ``get_tokenizer``
builds with ``tokenizers.ByteLevelBPETokenizer`` and loads back through
``transformers.AutoTokenizer`` (a ``GPT2TokenizerFast``), without either
package, which the card's machine does not have.

What it reproduces:

* GPT-2's byte-to-unicode table (``bytes_to_unicode``): every byte a
  printable character, so that a token is a string of them.
* The GPT-2 pre-tokenizer with no prefix space (``ByteLevel(
  add_prefix_space=False, use_regex=True)``).  Python's ``re`` has no
  ``\\p{L}`` / ``\\p{N}``, so letters are written ``[^\\W\\d_]`` and
  numbers ``\\d``: a character that is numeric but not a decimal digit
  (categories Nl and No: ``²``, ``½``, ``Ⅻ``) counts as a letter here
  and as a number in the ``tokenizers`` package.  No character of the
  repository's corpora is one (the tests check every one).
* Special tokens split out of the text before pre-tokenization, matched
  exactly: ``"text<eos_de>"`` gives text's ids, then ``<eos_de>``'s.
* Ids: the specials in the order given, then the 256 byte characters in
  code-point order, then one token a merge.
* Training as ``tokenizers``' ``BpeTrainer`` does it: pair counts kept
  incrementally over the distinct words, a max-heap of (count, pair) whose
  stale entries are refreshed when they surface, the best count first and
  ties to the smallest (id, id) pair; training stops at ``vocab_size``
  tokens or when the best count falls under ``min_frequency``.
* Encoding a word as the BPE model does: the adjacent pair of lowest merge
  rank first, leftmost first among equals.
* ``decode``: tokens (specials as their text) back through the byte table
  to UTF-8 with ``errors="replace"``, no clean-up of spaces, ids without a
  token left out.

``save`` writes ``tokenizer.json`` in the ``tokenizers`` layout (vocab and
merges, the specials as added tokens), which ``load`` reads back and which
``tokenizers.Tokenizer.from_file`` loads as well.
"""

from __future__ import annotations

import heapq
import json
import re

# GPT-2's pre-tokenizer pattern, letters and numbers as Python's re can say
# them (module docstring)
_LETTERS, _NUMBERS = r"[^\W\d_]", r"\d"
PRETOKENIZE = re.compile(
    rf"'s|'t|'re|'ve|'m|'ll|'d| ?{_LETTERS}+| ?{_NUMBERS}+"
    rf"| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's table: the printable bytes map to themselves, the others to
    the code points from 256 on, in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


BYTE_TO_CHAR = bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
# a UTF-8 string read as latin-1 has one code point a byte: translate them
_BYTE_LEVEL = str.maketrans({b: c for b, c in BYTE_TO_CHAR.items()})


def pretokenize(text: str) -> list[str]:
    """The text's pre-tokens, each as byte-level characters."""
    return [piece.encode("utf-8").decode("latin-1").translate(_BYTE_LEVEL)
            for piece in PRETOKENIZE.findall(text)]


class ByteLevelBPE:
    """A trained byte-level BPE: ``tok(text)["input_ids"]``, ``tok.vocab``
    (token -> id, specials included), ``len(tok)``, ``tok.decode(ids)``,
    ``save(path)`` and ``ByteLevelBPE.load(path)``."""

    def __init__(self, vocab: dict[str, int],
                 merges: list[tuple[str, str]], special_tokens: list[str]):
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.special_tokens = list(special_tokens)
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        # (id, id) -> (rank, new id); a pair merged twice keeps its later
        # rank, as the trainer's map of merges does
        self._ranks = {}
        for rank, (a, b) in enumerate(self.merges):
            self._ranks[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self._split = (re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self.special_tokens, key=len,
                                         reverse=True)) + ")")
            if self.special_tokens else None)
        self._cache: dict[str, list[int]] = {}

    # -- training ----------------------------------------------------------

    @classmethod
    def train_from_iterator(cls, texts, vocab_size: int,
                            special_tokens: list[str],
                            min_frequency: int = 2) -> "ByteLevelBPE":
        """Train on ``texts``: strings, or lists of strings (each string a
        sequence of its own, as ``tokenizers`` takes them)."""
        counts: dict[str, int] = {}
        for item in texts:
            for text in ([item] if isinstance(item, str) else item):
                for w in pretokenize(text):
                    counts[w] = counts.get(w, 0) + 1
        id_to_token = list(special_tokens)
        alphabet = sorted(set(BYTE_TO_CHAR.values()), key=ord)
        id_to_token += [c for c in alphabet if c not in id_to_token]
        token_to_id = {t: i for i, t in enumerate(id_to_token)}
        words = [[token_to_id[c] for c in w] for w in counts]
        word_counts = list(counts.values())

        pair_counts: dict[tuple[int, int], int] = {}
        where: dict[tuple[int, int], set[int]] = {}
        for i, w in enumerate(words):
            for pair in zip(w, w[1:]):
                pair_counts[pair] = pair_counts.get(pair, 0) + word_counts[i]
                where.setdefault(pair, set()).add(i)
        # max-heap of (count, smallest pair first): heapq is a min-heap; a
        # serial keeps entries of one pair in the order they were pushed
        serial = iter(range(1 << 62))
        heap = [(-pair_counts[p], p, next(serial), pos)
                for p, pos in where.items() if pair_counts[p] > 0]
        heapq.heapify(heap)
        merges: list[tuple[str, str]] = []
        while len(token_to_id) < vocab_size and heap:
            neg, pair, _, pos = heapq.heappop(heap)
            count = pair_counts[pair]
            if -neg != count:                     # stale: refresh it
                heapq.heappush(heap, (-count, pair, next(serial), pos))
                continue
            if count < 1 or count < min_frequency:
                break
            a, b = id_to_token[pair[0]], id_to_token[pair[1]]
            new = a + b
            if new not in token_to_id:
                token_to_id[new] = len(id_to_token)
                id_to_token.append(new)
            new_id = token_to_id[new]
            merges.append((a, b))
            changed: dict[tuple[int, int], set[int]] = {}
            for i in pos:
                for p, change in _merge_word(words[i], pair, new_id):
                    pair_counts[p] = (pair_counts.get(p, 0)
                                      + change * word_counts[i])
                    if change > 0:
                        changed.setdefault(p, set()).add(i)
            for p, where_p in changed.items():
                if pair_counts[p] > 0:
                    heapq.heappush(heap, (-pair_counts[p], p, next(serial),
                                          where_p))
        return cls(token_to_id, merges, special_tokens)

    # -- encoding and decoding ---------------------------------------------

    def __len__(self) -> int:
        return len(self.vocab)

    def __call__(self, text: str) -> dict[str, list[int]]:
        ids: list[int] = []
        pieces = self._split.split(text) if self._split else [text]
        for piece in pieces:
            if not piece:
                continue
            if piece in self.special_tokens:
                ids.append(self.vocab[piece])
                continue
            for w in pretokenize(piece):
                ids.extend(self._word_ids(w))
        return {"input_ids": ids}

    def _word_ids(self, word: str) -> list[int]:
        got = self._cache.get(word)
        if got is None:
            got = self._cache[word] = self._merge_all(
                [self.vocab[c] for c in word])
        return got

    def _merge_all(self, sym: list[int]) -> list[int]:
        """The BPE model's merge: a heap of (rank, position) over a linked
        list of symbols; an entry whose pair has changed is skipped."""
        n = len(sym)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self._ranks.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new_id = heapq.heappop(heap)
            if not alive[i] or nxt[i] == -1:
                continue
            j = nxt[i]
            m = self._ranks.get((sym[i], sym[j]))
            if m is None or m[1] != new_id:
                continue
            sym[i] = new_id
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                m = self._ranks.get((sym[prv[i]], sym[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] != -1:
                m = self._ranks.get((sym[i], sym[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def decode(self, ids) -> str:
        """The ids' text; an id with no token (a model's vocabulary may be
        larger than the tokenizer's) is left out, as ``tokenizers`` does."""
        out = bytearray()
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None:
                continue
            if all(c in CHAR_TO_BYTE for c in tok):
                out.extend(CHAR_TO_BYTE[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    # -- files -------------------------------------------------------------

    def save(self, path: str) -> None:
        """``tokenizer.json`` in the ``tokenizers`` package's layout."""
        byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                      "trim_offsets": True, "use_regex": True}
        doc = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [
                {"id": self.vocab[t], "content": t, "single_word": False,
                 "lstrip": False, "rstrip": False, "normalized": False,
                 "special": True} for t in self.special_tokens],
            "normalizer": None,
            "pre_tokenizer": byte_level,
            "post_processor": {**byte_level, "add_prefix_space": True,
                               "trim_offsets": False},
            "decoder": {**byte_level, "add_prefix_space": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": self.vocab,
                      "merges": [list(m) for m in self.merges]}}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "ByteLevelBPE":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        model = doc["model"]
        return cls(model["vocab"], [tuple(m) for m in model["merges"]],
                   [t["content"] for t in doc["added_tokens"]
                    if t.get("special")])


def _merge_word(word: list[int], pair: tuple[int, int], new_id: int):
    """Merge ``pair`` into ``new_id`` in place, left to right; returns the
    changes to the pair counts as the trainer's ``Word::merge`` gives them
    (the merged pair itself is not counted down)."""
    a, b = pair
    changes = []
    i = 0
    while i < len(word):
        if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
            if i > 0:
                changes.append(((word[i - 1], a), -1))
                changes.append(((word[i - 1], new_id), 1))
            word[i:i + 2] = [new_id]
            if i < len(word) - 1:
                changes.append(((b, word[i + 1]), -1))
                changes.append(((new_id, word[i + 1]), 1))
        i += 1
    return changes
