"""Chapter-title evaluation: ROUGE of generated titles and the three
baselines (lead, random, principal), and the result-file writer.

The port's own copy of video_chapter_generation_tpu/evalkit/title_eval.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .rouge import rouge_scores, rouge_scores_avg


def lead_baseline(text: str, n_words: int = 10) -> str:
    """Copied from video_chapter_generation_tpu/evalkit/title_eval.py:22."""
    return " ".join(text.split(" ")[:n_words])


def _windows(text: str, n_words: int = 10) -> List[str]:
    """Copied from video_chapter_generation_tpu/evalkit/title_eval.py:26."""
    words = text.split(" ")
    return [" ".join(words[k : k + n_words]) for k in range(0, len(words), n_words)]


def random_baseline(text: str, rng: np.random.Generator,
                    n_words: int = 10) -> str:
    """Copied from video_chapter_generation_tpu/evalkit/title_eval.py:31."""
    cands = _windows(text, n_words)
    return cands[int(rng.integers(0, len(cands)))] if cands else ""


def principal_baseline(text: str, n_words: int = 10) -> str:
    """Copied from video_chapter_generation_tpu/evalkit/title_eval.py:37."""
    cands = _windows(text, n_words)
    scores = []
    for sen in cands:
        if len(sen) <= 0:
            scores.append(0.0)
            continue
        scores.append(rouge_scores(sen, text)["rouge-1"]["f"])
    if not scores:
        return ""
    return cands[int(np.argmax(scores))]


def _filtered_avg(hyps: Sequence[str], refs: Sequence[str]) -> Dict:
    """Drop pairs with an empty hypothesis (the reference filters them),
    then average.

    Copied from video_chapter_generation_tpu/evalkit/title_eval.py:50.
    """
    pairs = [(h, r) for h, r in zip(hyps, refs) if len(h) > 0 and len(r) > 0]
    if not pairs:
        return {k: {"f": 0.0, "p": 0.0, "r": 0.0}
                for k in ("rouge-1", "rouge-2", "rouge-l")}
    h, r = zip(*pairs)
    return rouge_scores_avg(list(h), list(r))


def evaluate_titles(
    gen_texts: Sequence[str],
    gt_texts: Sequence[str],
    source_texts: Sequence[str],
    test_loss: Optional[float] = None,
    test_acc: Optional[float] = None,
    seed: int = 123,
) -> Dict:
    """Full title evaluation: generated + 3 baselines, each ROUGE-1/2/L.

    Copied from video_chapter_generation_tpu/evalkit/title_eval.py:61.
    """
    rng = np.random.default_rng(seed)
    rand_titles = [random_baseline(t, rng) for t in source_texts]
    lead_titles = [lead_baseline(t) for t in source_texts]
    pri_titles = [principal_baseline(t) for t in source_texts]

    return {
        "test_loss": test_loss,
        "test_acc": test_acc,
        "generated": _filtered_avg(gen_texts, gt_texts),
        "random": _filtered_avg(rand_titles, gt_texts),
        "lead": _filtered_avg(lead_titles, gt_texts),
        "principal": _filtered_avg(pri_titles, gt_texts),
    }


def write_title_result_file(result: Dict, result_file: str) -> None:
    """Reference layout: random/lead/principal rouge lines, then test loss/
    acc and generated rouge F values (pegasus_batch_16_440.txt).

    Copied from video_chapter_generation_tpu/evalkit/title_eval.py:85.
    """
    d = os.path.dirname(result_file)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(result_file, "w") as f:
        for name in ("random", "lead", "principal"):
            for k in ("rouge-1", "rouge-2", "rouge-l"):
                f.write(f"{name} {k} {result[name][k]}\n")
        f.write("\n")
        f.write(f"test_loss {result['test_loss']}\n")
        f.write(f"test_acc {result['test_acc']}\n")
        for k in ("rouge-1", "rouge-2", "rouge-l"):
            f.write(f"{k} f {result['generated'][k]['f']}\n")
