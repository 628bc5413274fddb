"""Host-side tokenizers, implemented from scratch (no network, no HF hub).

The port's own copy of video_chapter_generation_tpu/data/tokenization.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import math
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence


def _is_whitespace(ch: str) -> bool:
    """Copied from video_chapter_generation_tpu/data/tokenization.py:24."""
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    """Copied from video_chapter_generation_tpu/data/tokenization.py:30."""
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    """Copied from video_chapter_generation_tpu/data/tokenization.py:36."""
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    """Copied from video_chapter_generation_tpu/data/tokenization.py:43."""
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK pre-tokenizer with lowercasing and accent
    stripping — the `do_lower_case=True` BERT basic tokenizer.

    Copied from video_chapter_generation_tpu/data/tokenization.py:56.
    """

    def __init__(self, do_lower_case: bool = True, never_split: Sequence[str] = ()):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        orig_tokens = text.split()
        split_tokens: List[str] = []
        for token in orig_tokens:
            if token in self.never_split:
                split_tokens.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            split_tokens.extend(self._split_on_punc(token))
        return " ".join(split_tokens).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        chars = list(text)
        output: List[List[str]] = []
        start_new_word = True
        for ch in chars:
            if _is_punctuation(ch):
                output.append([ch])
                start_new_word = True
            else:
                if start_new_word:
                    output.append([])
                start_new_word = False
                output[-1].append(ch)
        return ["".join(x) for x in output]

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)


class WordPieceTokenizer:
    """BERT WordPiece tokenizer over a vocab list.

    Special tokens follow the vocab file; `never_split` keeps [CLS]/[SEP]/
    [PAD]/[UNK]/[MASK] atomic through basic tokenization so the reference's
    manual "[CLS] " + text scheme works identically.


    Copied from video_chapter_generation_tpu/data/tokenization.py:123.
    """

    SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def __init__(self, vocab: Sequence[str], do_lower_case: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.ids_to_tokens: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case, never_split=self.SPECIALS)
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_token = "[UNK]"
        self.pad_token = "[PAD]"
        self.cls_token = "[CLS]"
        self.sep_token = "[SEP]"
        self.mask_token = "[MASK]"

    # -- construction -----------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, **kw)

    @classmethod
    def build_from_corpus(
        cls, texts: Iterable[str], vocab_size: int = 2000, **kw
    ) -> "WordPieceTokenizer":
        """Tiny-vocab builder for tests/fixtures: specials + single chars +
        most frequent whole words."""
        from collections import Counter

        basic = BasicTokenizer(True, never_split=cls.SPECIALS)
        counts: Counter = Counter()
        chars: Counter = Counter()
        for t in texts:
            for tok in basic.tokenize(t):
                counts[tok] += 1
                for ch in tok:
                    chars[ch] += 1
        vocab = list(cls.SPECIALS)
        vocab += sorted(chars)
        vocab += ["##" + c for c in sorted(chars)]
        for tok, _ in counts.most_common():
            if tok not in vocab:
                vocab.append(tok)
            if len(vocab) >= vocab_size:
                break
        return cls(vocab, **kw)

    # -- tokenize ---------------------------------------------------------
    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        output: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            output.append(cur)
            start = end
        return output

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in self.basic.tokenize(text):
            if token in self.vocab:
                out.append(token)
            else:
                out.extend(self._wordpiece(token))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.SPECIALS]
        text = " ".join(toks)
        return text.replace(" ##", "")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class UnigramTokenizer:
    """SentencePiece-unigram-style tokenizer: Viterbi max-logprob
    segmentation over pieces with the "▁" word-start marker.

    Pegasus convention: pad=0 (doubles as decoder start token), eos=1
    ("</s>"), unk=2.


    Copied from video_chapter_generation_tpu/data/tokenization.py:229.
    """

    WS = "▁"  # ▁

    def __init__(self, pieces: Dict[str, float],
                 pad_token: str = "<pad>", eos_token: str = "</s>",
                 unk_token: str = "<unk>"):
        self.pad_token, self.eos_token, self.unk_token = pad_token, eos_token, unk_token
        specials = [pad_token, eos_token, unk_token]
        self.pieces = dict(pieces)
        vocab = specials + [p for p in pieces if p not in specials]
        self.vocab: Dict[str, int] = {p: i for i, p in enumerate(vocab)}
        self.ids_to_tokens = {i: p for p, i in self.vocab.items()}
        self._max_piece_len = max((len(p) for p in pieces), default=1)
        self._unk_score = min(pieces.values(), default=-10.0) - 10.0

    # -- construction -----------------------------------------------------
    @classmethod
    def from_tsv(cls, path: str, **kw) -> "UnigramTokenizer":
        """Load `piece<TAB>logprob` lines (sentencepiece export format)."""
        pieces: Dict[str, float] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                piece, score = line.rstrip("\n").split("\t")
                pieces[piece] = float(score)
        return cls(pieces, **kw)

    @classmethod
    def build_from_corpus(
        cls, texts: Iterable[str], vocab_size: int = 2000, **kw
    ) -> "UnigramTokenizer":
        """Frequency-scored word+char vocab for tests: whole words (with ▁)
        get log-frequency scores, chars act as fallback."""
        from collections import Counter

        words: Counter = Counter()
        chars: Counter = Counter()
        for t in texts:
            for w in t.split():
                words[cls.WS + w] += 1
                for ch in w:
                    chars[ch] += 1
                chars[cls.WS] += 1
        total = sum(words.values()) + sum(chars.values()) + 1
        pieces: Dict[str, float] = {}
        for ch, c in chars.items():
            pieces[ch] = math.log(c / total) - 5.0  # chars are a weak fallback
        for w, c in words.most_common(vocab_size):
            pieces[w] = math.log(c / total)
        return cls(pieces, **kw)

    # -- tokenize ---------------------------------------------------------
    def _viterbi(self, s: str) -> List[str]:
        n = len(s)
        best = [-math.inf] * (n + 1)
        back: List[Optional[int]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -math.inf:
                continue
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                piece = s[i:j]
                score = self.pieces.get(piece)
                if score is None:
                    if j - i == 1:
                        score = self._unk_score  # unknown single char
                    else:
                        continue
                if best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = i
        # backtrack
        out: List[str] = []
        j = n
        while j > 0:
            i = back[j]
            assert i is not None
            out.append(s[i:j])
            j = i
        out.reverse()
        return out

    def tokenize(self, text: str) -> List[str]:
        text = " ".join(text.split())
        if not text:
            return []
        s = self.WS + text.replace(" ", self.WS)
        return self._viterbi(s)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            specials = {self.pad_token, self.eos_token, self.unk_token}
            toks = [t for t in toks if t not in specials]
        return "".join(toks).replace(self.WS, " ").strip()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def eos_id(self) -> int:
        return self.vocab[self.eos_token]
