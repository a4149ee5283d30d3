"""The hash tokenizer of the plain reference: the port's `data/tokenizer.py`
fallback (no BPE files are in the repository), frozen. CLIP's layout:
lowercase, collapsed whitespace, [SOT, tokens..., EOT] padded with EOT to
77 ids, at most 75 content tokens."""

from __future__ import annotations

import hashlib
import html
import re

import numpy as np

MAX_LEN = 77
SOT = 49406
EOT = 49407


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


def encode(text: str, max_len: int = MAX_LEN) -> np.ndarray:
    """-> (max_len,) int32: a stable pseudo-id per word (md5)."""
    ids = [1 + int(hashlib.md5(tok.encode()).hexdigest(), 16) % (SOT - 1)
           for tok in _clean(text).split(" ") if tok]
    seq = [SOT] + ids[: max_len - 2] + [EOT]
    return np.asarray(seq + [EOT] * (max_len - len(seq)), dtype=np.int32)
