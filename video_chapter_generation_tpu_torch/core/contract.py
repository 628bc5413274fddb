"""Checkpoint-carried train/eval config contract.

The port's own copy of video_chapter_generation_tpu/core/contract.py (every definition;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import hashlib
from typing import Dict, Optional


CONTRACT_KEY = "contract"


class ContractMismatch(RuntimeError):
    """Copied from video_chapter_generation_tpu/core/contract.py:27."""
    pass


def build_contract(**fields) -> Dict:
    """JSON-safe contract dict; None-valued fields are dropped.

    Copied from video_chapter_generation_tpu/core/contract.py:31.
    """
    out = {}
    for k, v in fields.items():
        if v is None:
            continue
        if hasattr(v, "item"):  # numpy scalar
            v = v.item()
        out[k] = v
    return out


def vocab_hash(tokenizer) -> Optional[str]:
    """Stable hash of a tokenizer's vocabulary — or of a plain word list
    (the from-scratch GPT's word-level vocab). Order-sensitive: ids must
    map to the same tokens, not just the same set.

    Copied from video_chapter_generation_tpu/core/contract.py:43.
    """
    if isinstance(tokenizer, (list, tuple)):
        vocab = list(tokenizer)
    else:
        vocab = getattr(tokenizer, "vocab", None)
    if isinstance(vocab, dict):  # token -> id; hash in id order
        toks = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    elif vocab is not None:
        toks = list(vocab)
    else:
        return None
    h = hashlib.md5()
    for tok in toks:
        h.update(str(tok).encode("utf-8"))
        h.update(b"\0")
    return h.hexdigest()[:16]


def assert_contract(saved: Optional[Dict], current: Dict,
                    context: str = "checkpoint") -> None:
    """Hard-fail on any key present in BOTH dicts with different values.

    `saved` None/empty (pre-contract checkpoints) passes — the contract
    is advisory-absent, never silently wrong.


    Copied from video_chapter_generation_tpu/core/contract.py:64.
    """
    if not saved:
        return
    mismatches = [
        (k, saved[k], current[k])
        for k in sorted(current)
        if k in saved and saved[k] != current[k]
    ]
    if mismatches:
        lines = "\n".join(
            f"  {k}: checkpoint={s!r} vs current={c!r}"
            for k, s, c in mismatches
        )
        raise ContractMismatch(
            f"{context}: config does not match the checkpoint's training "
            f"contract:\n{lines}\n"
            "Fix the flags/config to match the checkpoint (or retrain)."
        )
