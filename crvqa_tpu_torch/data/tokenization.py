"""Self-contained BERT WordPiece tokenizer (the port's copy of
`crvqa_tpu/data/tokenization.py`): pure Python, plus the native C++ bulk
encoder (`native/wordpiece.py`) behind `raw_ids_batch`.

The exact algorithm of the vendored `hg_transformers/tokenization_bert.py`
(BasicTokenizer :347-483, WordpieceTokenizer :485-543): text cleaning, CJK
isolation, lowercase + NFD accent stripping, punctuation splitting, then
greedy longest-match-first WordPiece with '##' continuations. Special
tokens split out of the raw text first, as HF's `split_on_tokens` does.
"""
from __future__ import annotations

import unicodedata
from typing import Iterable, Sequence, Union

from ..native.wordpiece import NativeWordPiece, dense_ids

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_whitespace(ch: str) -> bool:
    # \t/\n/\r are control chars in unicode, but BERT treats them as spaces
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumerics count as punctuation even when unicode
    # disagrees ('$', '@', '`', ...) — tokenization_bert.py:569-583
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _isolate_cjk(text: str) -> str:
    return "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _split_punc(token: str) -> list[str]:
    pieces: list[list[str]] = []
    fresh = True
    for ch in token:
        if _is_punctuation(ch):
            pieces.append([ch])
            fresh = True
        else:
            if fresh:
                pieces.append([])
            fresh = False
            pieces[-1].append(ch)
    return ["".join(p) for p in pieces]


def basic_tokenize(text: str, do_lower_case: bool = True,
                   never_split: Iterable[str] = ()) -> list[str]:
    """BasicTokenizer.tokenize (tokenization_bert.py:370-399)."""
    never = set(never_split)
    text = _isolate_cjk(_clean(text))
    out: list[str] = []
    for token in text.split():
        if token in never:
            out.append(token)
            continue
        if do_lower_case:
            token = _strip_accents(token.lower())
        out.extend(_split_punc(token))
    return [t for t in out if t]


def wordpiece_tokenize(token: str, vocab: dict, unk: str,
                       max_chars: int = 100) -> list[str]:
    """Greedy longest-match-first WordPiece
    (WordpieceTokenizer.tokenize, tokenization_bert.py:493-543)."""
    if len(token) > max_chars:
        return [unk]
    pieces: list[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        match = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                match = sub
                break
            end -= 1
        if match is None:
            return [unk]
        pieces.append(match)
        start = end
    return pieces


SPECIAL_TOKENS = ("[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]")


class WordPieceTokenizer:
    """The slice of `BertTokenizer` the training and serving paths use, over
    a BERT `vocab.txt` (one token per line, id = line number).

    Batches go through `raw_ids_batch`: rows of ASCII text through the
    native encoder (built with g++ at the first batch; a failed build
    raises), the rest through the Python algorithm, with the same ids. The
    Python path takes every row when `native` is False, when the vocab's
    ids are not 0..n-1 (a repeated line in vocab.txt) or without
    lowercasing (the C++ encoder implements the lowercasing spec), as in
    the JAX package."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 native: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token, self.cls_token, self.sep_token = (
            "[UNK]", "[CLS]", "[SEP]")
        self.pad_token = "[PAD]"
        self.all_special_tokens = list(SPECIAL_TOKENS)
        for t in self.all_special_tokens:
            if t not in self.vocab:
                raise ValueError(f"special token {t!r} missing from vocab")
        self.unk_token_id = self.vocab[self.unk_token]
        self.cls_token_id = self.vocab[self.cls_token]
        self.sep_token_id = self.vocab[self.sep_token]
        self.pad_token_id = self.vocab[self.pad_token]
        self._native = None if (native and do_lower_case
                                and dense_ids(self.vocab)) else False

    def _native_handle(self):
        """The native encoder (built at the first call), or False."""
        if self._native is None:
            self._native = NativeWordPiece(
                self.vocab, self.all_special_tokens, self.unk_token_id)
        return self._native

    def raw_ids_batch(self, texts: Sequence[str], cap: int = 512
                      ) -> list[list[int]]:
        """Raw wordpiece ids per text, at most `cap` (no specials added):
        the bulk tokenization entry (`crvqa_tpu/data/tokenization.py:
        159-173`). ASCII rows run through the native encoder; a row with a
        non-ASCII byte, or with a special token glued to other text (HF
        splits those out as substrings, the C++ encoder only between
        spaces), through the Python algorithm."""
        native = self._native_handle()
        if native:
            rows = native.encode_batch(list(texts), cap=cap)
            rows = [None if self._has_glued_special(t) else r
                    for r, t in zip(rows, texts)]
        else:
            rows = [None] * len(texts)
        return [r if r is not None
                else self.convert_tokens_to_ids(self.tokenize(t))[:cap]
                for r, t in zip(rows, texts)]

    def _has_glued_special(self, text: str) -> bool:
        """True if a special token occurs not delimited by whitespace."""
        for sp in self.all_special_tokens:
            start = 0
            while True:
                i = text.find(sp, start)
                if i < 0:
                    break
                j = i + len(sp)
                if not ((i == 0 or text[i - 1].isspace())
                        and (j == len(text) or text[j].isspace())):
                    return True
                start = j
        return False

    def _split_on_specials(self, text: str) -> list[str]:
        """Split special tokens out of the raw text as substrings, before
        basic tokenization (HF's `split_on_tokens`)."""
        parts = [text]
        for sp in self.all_special_tokens:
            nxt: list[str] = []
            for p in parts:
                if p in self.all_special_tokens:
                    nxt.append(p)
                    continue
                pieces = p.split(sp)
                for i, frag in enumerate(pieces):
                    if i:
                        nxt.append(sp)
                    if frag:
                        nxt.append(frag)
            parts = nxt
        return parts

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for part in self._split_on_specials(text):
            if part in self.all_special_tokens:
                out.append(part)
                continue
            for token in basic_tokenize(part, self.do_lower_case,
                                        self.all_special_tokens):
                out.extend(wordpiece_tokenize(token, self.vocab,
                                              self.unk_token))
        return out

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def __call__(self, texts, padding: str = "max_length",
                 truncation: bool = True, max_length: int = 25,
                 add_special_tokens: bool = True) -> dict:
        """Fixed-length batch encoding (the JAX tokenizer's `__call__` with
        `padding="max_length"`, `crvqa_tpu/data/tokenization.py:268-302`):
        [CLS] + wordpieces cut to max_length - 2 + [SEP], padded with
        [PAD]; returns {"input_ids", "attention_mask"} as lists of rows."""
        if padding != "max_length" or not truncation:
            raise NotImplementedError("only padding='max_length' with "
                                      "truncation is ported")
        if isinstance(texts, str):
            texts = [texts]
        ids, mask = [], []
        for r in self.raw_ids_batch(texts, cap=max(512, max_length)):
            if add_special_tokens:
                r = ([self.cls_token_id] + r[: max(0, max_length - 2)]
                     + [self.sep_token_id])
            else:
                r = r[:max_length]
            pad_n = max(0, max_length - len(r))
            ids.append(r + [self.pad_token_id] * pad_n)
            mask.append([1] * len(r) + [0] * pad_n)
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Ids -> text: '##' pieces joined, HF's clean-up of punctuation and
        contractions (`crvqa_tpu/data/tokenization.py:305-315`)."""
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.all_special_tokens]
        text = " ".join(toks).replace(" ##", "")
        for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                     (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                     (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
            text = text.replace(a, b)
        return text
