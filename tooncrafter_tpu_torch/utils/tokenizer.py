"""CLIP byte-level BPE tokenizer (pure Python, no open_clip).

Functional equivalent of open_clip's SimpleTokenizer + tokenize() used by
the reference text encoder (`condition.py:210-213`): lowercased,
whitespace-collapsed text -> byte-level BPE ids, wrapped in
<|startoftext|> ... <|endoftext|> and zero-padded to 77.

The merges table (`bpe_simple_vocab_16e6.txt[.gz]`) ships with the model
checkpoint, not this repo; pass its path to `ClipTokenizer`. Note:
open_clip additionally runs ftfy.fix_text for mojibake repair; for
well-formed prompts the html-unescape here is identical.

The pattern needs the ``regex`` package (its Unicode letter and number
classes). It is imported when a tokenizer is built, so this module
imports without it and the CLI runs without it unless --bpe_path is given.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte <-> unicode printable-character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str, whitespace) -> str:
    text = html.unescape(html.unescape(text))
    text = whitespace.sub(" ", text)
    return text.strip().lower()


class ClipTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[Sequence[str]] = None):
        try:
            import regex
        except ImportError as e:
            raise ImportError(
                "ClipTokenizer needs the 'regex' package (Unicode classes "
                "in the CLIP token pattern); install it or run without "
                "--bpe_path") from e
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            if bpe_path is None or not os.path.exists(bpe_path):
                raise FileNotFoundError(
                    "CLIP BPE merges file not found; pass bpe_path to the "
                    "vocab that ships with the checkpoint "
                    "(bpe_simple_vocab_16e6.txt.gz)")
            if bpe_path.endswith(".gz"):
                with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                    raw = f.read()
            else:
                with open(bpe_path, encoding="utf-8") as f:
                    raw = f.read()
            merges = raw.split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.whitespace = regex.compile(r"\s+")
        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex.IGNORECASE)
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in self.pat.findall(_clean(text, self.whitespace)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Iterable[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Batch-tokenize to (N, context_length) int32, zero-padded; long
        prompts are truncated with the eot token preserved."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out
