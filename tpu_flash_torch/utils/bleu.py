"""Corpus BLEU as ``sacrebleu.metrics.BLEU()`` computes it by default, the
port's own (the card's machine has no ``sacrebleu``): the ``13a``
tokenizer with case kept, n-grams up to 4 clipped by the reference's
counts, the brevity penalty, and ``smooth_method="exp"``; the score is
0-100.  The JAX package's ``evaluate_bleu`` (``apps/machine_translation.py:
298-306``) calls ``sacrebleu``; the tests hold this against it.
"""

from __future__ import annotations

import collections
import math
import re

MAX_ORDER = 4

# mteval-v13a's substitutions after the language-independent part
_13A = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),     # . and , not after a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),     # . and , not before one
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),          # - after a digit
)


def tokenize_13a(line: str) -> str:
    """sacrebleu's ``Tokenizer13a`` of a stripped segment."""
    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = line.replace("&quot;", '"')
        line = line.replace("&amp;", "&")
        line = line.replace("&lt;", "<")
        line = line.replace("&gt;", ">")
    line = f" {line} "
    for pattern, repl in _13A:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(line: str) -> tuple[collections.Counter, int]:
    tokens = line.split()
    grams = collections.Counter(
        tuple(tokens[i:i + n]) for n in range(1, MAX_ORDER + 1)
        for i in range(len(tokens) - n + 1))
    return grams, len(tokens)


def _segment_stats(hyp: str, refs: list[str]) -> list[int]:
    """``[hyp_len, ref_len, correct_1..4, total_1..4]``: the closest
    reference length (the shorter on a tie), the clipped matches."""
    ref_grams: collections.Counter = collections.Counter()
    ref_lens = []
    for ref in refs:
        grams, n = _ngrams(tokenize_13a(ref.rstrip()))
        ref_lens.append(n)
        for g, c in grams.items():
            ref_grams[g] = max(ref_grams[g], c)
    hyp_grams, hyp_len = _ngrams(tokenize_13a(hyp.rstrip()))
    ref_len = min(ref_lens, key=lambda n: (abs(hyp_len - n), n))
    correct, total = [0] * MAX_ORDER, [0] * MAX_ORDER
    for g, c in hyp_grams.items():
        total[len(g) - 1] += c
        if g in ref_grams:
            correct[len(g) - 1] += min(c, ref_grams[g])
    return [hyp_len, ref_len] + correct + total


def _log(x: float) -> float:
    return -9999999999 if x == 0.0 else math.log(x)


def score_from_stats(sys_len: int, ref_len: int, correct: list[int],
                     total: list[int]) -> float:
    """sacrebleu's ``compute_bleu`` with ``smooth_method="exp"``."""
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_ORDER
    if not any(correct):
        return 0.0
    smooth = 1.0
    for n in range(1, MAX_ORDER + 1):
        if total[n - 1] == 0:
            break
        if correct[n - 1] == 0:
            smooth *= 2
            precisions[n - 1] = 100.0 / (smooth * total[n - 1])
        else:
            precisions[n - 1] = 100.0 * correct[n - 1] / total[n - 1]
    return bp * math.exp(sum(_log(p) for p in precisions) / MAX_ORDER)


def corpus_bleu(hypotheses: list[str], references: list[list[str]]) -> float:
    """``BLEU().corpus_score(hypotheses, references).score``:
    ``references`` is a list of reference streams, each aligned with
    ``hypotheses``."""
    if any(len(stream) != len(hypotheses) for stream in references):
        raise ValueError("every reference stream must have one segment a "
                         "hypothesis")
    sums = [0] * (2 + 2 * MAX_ORDER)
    for i, hyp in enumerate(hypotheses):
        stats = _segment_stats(hyp, [stream[i] for stream in references])
        sums = [a + b for a, b in zip(sums, stats)]
    return score_from_stats(sums[0], sums[1], sums[2:2 + MAX_ORDER],
                            sums[2 + MAX_ORDER:])
