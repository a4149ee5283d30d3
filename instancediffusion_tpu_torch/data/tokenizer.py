"""CLIP byte-level BPE tokenizer, host side (counterpart of
`instancediffusion_tpu/data/tokenizer.py`, copied so the port imports
nothing of the JAX package).

Reads CLIP's vocab.json / merges.txt from $CLIP_TOKENIZER_DIR or from
`instancediffusion_tpu/assets/clip_bpe/` of the checkout (where
`tools/fetch_clip_bpe.py` puts them). Without them it falls back to a
deterministic hash of each word, which runs the pipeline at the real cost
but gives meaningless token ids, so `require_real` refuses it unless
IDTPU_ALLOW_HASH_TOKENIZER=1.

CLIP specifics: lowercase, collapsed whitespace, word tokens end in
"</w>", sequences are <|startoftext|> ... <|endoftext|> padded with the
EOT id to 77 tokens, at most 75 content tokens.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import os
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

MAX_LEN = 77
SOT = 49406
EOT = 49407
VOCAB_SIZE = 49408

ASSETS_DIR = str(Path(__file__).resolve().parents[2] / "instancediffusion_tpu" / "assets"
                 / "clip_bpe")

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class CLIPTokenizer:
    def __init__(self, vocab: dict[str, int] | None, merges: list[tuple[str, str]] | None):
        self.vocab = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)} if merges is not None else None
        self.byte_encoder = _bytes_to_unicode()
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPTokenizer":
        opener = gzip.open if merges_path.endswith(".gz") else open
        with open(vocab_path) as f:
            vocab = json.load(f)
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        return cls(vocab, merges)

    @classmethod
    def load_default(cls) -> "CLIPTokenizer":
        """$CLIP_TOKENIZER_DIR, then ASSETS_DIR, then the hash fallback."""
        for d in (os.environ.get("CLIP_TOKENIZER_DIR"), ASSETS_DIR):
            if d and os.path.exists(os.path.join(d, "vocab.json")):
                return cls.from_files(os.path.join(d, "vocab.json"),
                                      os.path.join(d, "merges.txt"))
        return cls(None, None)

    def require_real(self, context: str = "this path") -> "CLIPTokenizer":
        """Refuse the hash fallback unless IDTPU_ALLOW_HASH_TOKENIZER=1."""
        if self.is_fallback and os.environ.get("IDTPU_ALLOW_HASH_TOKENIZER", "") != "1":
            raise RuntimeError(
                f"CLIP vocab.json/merges.txt not found: refusing to run {context} "
                f"with the hash-fallback tokenizer (its token ids are meaningless). "
                f"Run `python tools/fetch_clip_bpe.py` or set CLIP_TOKENIZER_DIR; "
                f"set IDTPU_ALLOW_HASH_TOKENIZER=1 to accept the fallback for "
                f"asset-free benchmarks and tests."
            )
        return self

    @property
    def is_fallback(self) -> bool:
        return self.vocab is None

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str, max_len: int = MAX_LEN) -> np.ndarray:
        """-> (max_len,) int32: [SOT, tokens..., EOT, EOT-pad...]."""
        text = _clean(text)
        ids: list[int] = []
        if self.vocab is not None:
            for tok in _PAT.findall(text):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.vocab.get(t, 0) for t in self._bpe(tok))
        else:
            # deterministic hash fallback: a stable pseudo-id per word
            for tok in text.split(" "):
                if tok:
                    h = int(hashlib.md5(tok.encode()).hexdigest(), 16)
                    ids.append(1 + h % (SOT - 1))
        seq = [SOT] + ids[: max_len - 2] + [EOT]
        seq = seq + [EOT] * (max_len - len(seq))
        return np.asarray(seq, dtype=np.int32)
