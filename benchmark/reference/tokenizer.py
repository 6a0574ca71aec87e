"""CLIP BPE tokenizer (host side, pure Python): the port's own copy of
``sam3_lora_tpu/models/tokenizer.py``.

The standard CLIP byte-level BPE scheme: a gzip vocab of 48,894 merge rules,
a 49,408-entry vocabulary (256 bytes + 256 byte+'</w>' + merges +
``<start_of_text>``/``<end_of_text>``), regex pre-tokenization, lowercase
cleaning, pad to the context length with id 0. The vocab file ships in
``sam3_lora_tpu_torch/assets/bpe_simple_vocab_16e6.txt.gz`` (the same blob
as the JAX package's). Cleaning is html-unescape + whitespace normalization
(no ftfy), which is exact for ASCII category names.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import List, Optional, Sequence, Union

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "bpe_simple_vocab_16e6.txt.gz")
DEFAULT_CONTEXT_LENGTH = 32


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte <-> printable-unicode bijection (standard table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(
        self,
        bpe_path: str = DEFAULT_BPE_PATH,
        context_length: int = DEFAULT_CONTEXT_LENGTH,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        special_tokens = ["<start_of_text>", "<end_of_text>"]
        vocab += special_tokens
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {t: t for t in special_tokens}
        special = "|".join(special_tokens)
        self.pat = re.compile(
            special + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )
        self.vocab_size = len(self.encoder)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if first in word[i:]:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                else:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in re.findall(self.pat, text):
            tok_u = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok_u).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self,
        texts: Union[str, List[str]],
        context_length: Optional[int] = None,
    ) -> np.ndarray:
        """Tokenize to a fixed (N, context_length) int32 array, 0-padded;
        overlong inputs truncate with the final token forced to eot
        (tokenizer_ve.py:243-252)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(toks) > ctx:
                toks = toks[:ctx]
                toks[-1] = self.eot_token_id
            out[i, : len(toks)] = toks
        return out


@functools.lru_cache(maxsize=1)
def get_default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()
