"""ROUGE-1/2/L scoring, from scratch (no external `rouge` dependency).

The port's own copy of video_chapter_generation_tpu/evalkit/rouge.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence


def _tokens(s: str) -> List[str]:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:16."""
    return [t for t in s.split() if t]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:20."""
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _prf(overlap: int, hyp_count: int, ref_count: int) -> Dict[str, float]:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:24."""
    p = overlap / hyp_count if hyp_count > 0 else 0.0
    r = overlap / ref_count if ref_count > 0 else 0.0
    f = 2.0 * ((p * r) / (p + r + 1e-8))
    return {"f": f, "p": p, "r": r}


def rouge_n(hypothesis: str, reference: str, n: int) -> Dict[str, float]:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:31."""
    hyp = _ngrams(_tokens(hypothesis), n)
    ref = _ngrams(_tokens(reference), n)
    overlap = sum((hyp & ref).values())
    return _prf(overlap, sum(hyp.values()), sum(ref.values()))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:38."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


def rouge_l(hypothesis: str, reference: str) -> Dict[str, float]:
    """Copied from video_chapter_generation_tpu/evalkit/rouge.py:54."""
    hyp = _tokens(hypothesis)
    ref = _tokens(reference)
    lcs = _lcs_len(hyp, ref)
    return _prf(lcs, len(hyp), len(ref))


def rouge_scores(hypothesis: str, reference: str) -> Dict[str, Dict[str, float]]:
    """{'rouge-1': {f,p,r}, 'rouge-2': ..., 'rouge-l': ...} for one pair.

    Copied from video_chapter_generation_tpu/evalkit/rouge.py:61.
    """
    return {
        "rouge-1": rouge_n(hypothesis, reference, 1),
        "rouge-2": rouge_n(hypothesis, reference, 2),
        "rouge-l": rouge_l(hypothesis, reference),
    }


def rouge_scores_avg(
    hypotheses: Sequence[str], references: Sequence[str]
) -> Dict[str, Dict[str, float]]:
    """Mean of per-pair scores (the `rouge` package's avg=True behaviour).

    Copied from video_chapter_generation_tpu/evalkit/rouge.py:70.
    """
    assert len(hypotheses) == len(references)
    acc = {
        k: {m: 0.0 for m in ("f", "p", "r")}
        for k in ("rouge-1", "rouge-2", "rouge-l")
    }
    n = len(hypotheses)
    for h, r in zip(hypotheses, references):
        s = rouge_scores(h, r)
        for k in acc:
            for m in acc[k]:
                acc[k][m] += s[k][m]
    if n:
        for k in acc:
            for m in acc[k]:
                acc[k][m] /= n
    return acc
