"""CLIP byte-level BPE tokenizer, pure python (the JAX package's
``data/tokenizer.py``; CLIP's ``simple_tokenizer`` + ``clip.tokenize``):
byte→unicode mapping, merge-rank BPE with ``</w>`` word terminals,
``<|startoftext|>`` / ``<|endoftext|>`` specials, a fixed ``context_length``
with zero padding.

The 49408-entry vocabulary comes from ``bpe_simple_vocab_16e6.txt.gz``, which
the repository does not hold.  When a vocabulary file is given it is loaded
for exact CLIP ids; otherwise a deterministic **byte-level fallback** is
used: ids 0-511 are the byte / byte+``</w>`` symbols (the first 512 entries
of the real vocabulary), SOT/EOT keep their real ids 49406/49407, so CLIP's
argmax-EOT pooling still finds the end.

Words are split with the standard library's ``re`` and ASCII classes (the
JAX package's fallback pattern): on ASCII text, which the clinical prompts
are, it splits as the ``regex`` package's Unicode classes do.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Sequence

import numpy as np

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)

SOT_ID = 49406
EOT_ID = 49407


@lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode map (GPT-2/CLIP standard)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
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


def _basic_clean(text: str) -> str:
    # ftfy.fix_text is unavailable; clinical prompts are plain ASCII
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """``vocab_size``: cap ids into a smaller embedding table (tiny test
    configs set ``Config.clip_vocab`` to e.g. 64).  Regular ids map to
    ``id % (vocab_size - 2)``; SOT/EOT become ``vocab_size - 2/-1`` so
    EOT stays the maximum id and CLIP's argmax-EOT pooling invariant
    holds; without it the fallback's ids 49406/49407 overflow a small
    table.  ``None`` or >= 49408 (the real vocab): no remapping."""

    def __init__(self, bpe_path: str | None = None,
                 vocab_size: int | None = None):
        self.vocab_size = (int(vocab_size)
                           if vocab_size and vocab_size < 49408 else None)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        base = list(self.byte_encoder.values())
        vocab = base + [v + "</w>" for v in base]
        self.bpe_ranks = {}
        if bpe_path and os.path.exists(bpe_path):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab += ["".join(m) for m in merges]
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            # byte-level fallback: ids 0-511 + real SOT/EOT ids
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.encoder["<|startoftext|>"] = SOT_ID
            self.encoder["<|endoftext|>"] = EOT_ID
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    @property
    def sot(self) -> int:
        if self.vocab_size:
            return self.vocab_size - 2
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        if self.vocab_size:
            return self.vocab_size - 1
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
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
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        if self.vocab_size:
            ids = [i % (self.vocab_size - 2) for i in ids]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(texts: str | Sequence[str], context_length: int = 77,
             tokenizer: ClipTokenizer | None = None,
             truncate: bool = False) -> np.ndarray:
    """(len(texts), context_length) int32 ids, SOT…EOT zero-padded.  Raises
    on overflow unless ``truncate``; ``tokenizer`` defaults to the
    byte-level fallback."""
    tokenizer = tokenizer or ClipTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tokenizer.sot] + tokenizer.encode(text) + [tokenizer.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}")
            ids = ids[:context_length - 1] + [tokenizer.eot]
        out[i, :len(ids)] = ids
    return out
