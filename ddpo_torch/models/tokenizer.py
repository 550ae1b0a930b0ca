"""CLIP tokenizer: first-party BPE over local vocab/merges data, with a
deterministic hash fallback for random-weight testing and benchmarking.

The reference tokenizes with transformers' CLIPTokenizer to a fixed 77 tokens
(pipeline_flax_stable_diffusion.py:148-161). Here the byte-pair-encoding
algorithm itself is first-party (``CLIPBPETokenizer``): only the
``vocab.json``/``merges.txt`` *data* files are external. Token-id parity with
transformers' CLIPTokenizer is oracle-tested in tests/test_tokenizer.py. In
this zero-egress environment the BPE vocab may be unavailable, so
``get_tokenizer`` degrades to a hash-based tokenizer with the same interface
and shape contract — sufficient for everything except matching real
checkpoints' text conditioning; drivers warn loudly via ``is_fallback``.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import unicodedata
from typing import List, Sequence, Union

import numpy as np

MODEL_MAX_LENGTH = 77
VOCAB_SIZE = 49408
BOS_ID = 49406
EOS_ID = 49407


class HashTokenizer:
    """Deterministic word-hash tokenizer with the CLIP shape contract.

    ids = [BOS, hash(word_0), ..., EOS, EOS...] padded to 77. Same string
    always maps to the same ids (so per-prompt stat tracking and caching
    behave), distinct words rarely collide.
    """

    model_max_length = MODEL_MAX_LENGTH
    vocab_size = VOCAB_SIZE
    is_fallback = True

    def __call__(self, texts: Union[str, Sequence[str]], max_length: int | None = None):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        ids = np.full((len(texts), max_length), EOS_ID, dtype=np.int32)
        ids[:, 0] = BOS_ID
        for row, text in enumerate(texts):
            words = text.lower().split()[: max_length - 2]
            for col, word in enumerate(words, start=1):
                digest = hashlib.md5(word.encode()).digest()
                ids[row, col] = int.from_bytes(digest[:4], "little") % (BOS_ID - 1) + 1
        return ids

    def decode(self, ids) -> str:
        raise NotImplementedError("fallback tokenizer is not invertible")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode():
    """GPT-2/CLIP reversible byte <-> printable-unicode map (data table)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def bpe_merge(token: str, ranks: dict, end: str = "") -> List[str]:
    """Greedy lowest-rank pair merging of ``token``'s characters, the last
    one carrying the end-of-word marker ``end`` (CLIP's ``</w>``; GPT-2's
    byte-level BPE has none)."""
    word = tuple(token[:-1]) + (token[-1] + end,)
    while len(word) > 1:
        pairs = set(zip(word[:-1], word[1:]))
        bigram = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if bigram not in ranks:
            break
        first, second = bigram
        merged = []
        i = 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                merged.append(first + second)
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = tuple(merged)
    return list(word)


def _basic_clean(text: str) -> str:
    """Lowercased whitespace-normalized text, matching transformers'
    CLIPTokenizer non-ftfy path (BasicTokenizer with strip_accents=False,
    do_split_on_punc=False): drop control/invalid chars, space out CJK,
    collapse whitespace, lowercase."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue
        if (
            0x4E00 <= cp <= 0x9FFF
            or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F
        ):
            out.append(f" {ch} ")
        elif ch.isspace() or cat == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    return " ".join("".join(out).split()).lower()


@functools.lru_cache(maxsize=1)
def _word_pattern():
    import regex

    return regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        regex.IGNORECASE,
    )


class CLIPBPETokenizer:
    """First-party CLIP byte-pair-encoding tokenizer.

    Implements the algorithm used by transformers' CLIPTokenizer (itself
    OpenAI CLIP's simple_tokenizer): regex word split, byte->unicode encode,
    greedy lowest-rank pair merging with a ``</w>`` end-of-word marker.
    Only ``vocab.json`` / ``merges.txt`` are external data.
    """

    is_fallback = False
    model_max_length = MODEL_MAX_LENGTH

    def __init__(self, vocab: dict, merges: List[tuple]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self.unk_id = self.eos_id
        self.vocab_size = len(self.encoder)
        self._cache: dict = {}

    @classmethod
    def from_dir(cls, path: str) -> "CLIPBPETokenizer":
        """Load from a directory holding vocab.json + merges.txt (the layout
        of HF tokenizer repos, e.g. an SD checkpoint's tokenizer/ subdir)."""
        for sub in ("", "tokenizer"):
            base = os.path.join(path, sub) if sub else path
            vocab_path = os.path.join(base, "vocab.json")
            merges_path = os.path.join(base, "merges.txt")
            if os.path.exists(vocab_path) and os.path.exists(merges_path):
                break
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(line.split()) for line in lines if line]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        result = bpe_merge(token, self.bpe_ranks, "</w>")
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Content token ids (no BOS/EOS, no padding/truncation)."""
        ids: List[int] = []
        for word in _word_pattern().findall(_basic_clean(text)):
            if word in ("<|startoftext|>", "<|endoftext|>"):
                # literal special tokens pass through (HF added-token trie)
                ids.append(self.encoder.get(word, self.unk_id))
                continue
            encoded = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            for tok in self._bpe(encoded):
                ids.append(self.encoder.get(tok, self.unk_id))
        return ids

    def __call__(self, texts: Union[str, Sequence[str]], max_length: int | None = None):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.eos_id, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: max_length - 2]
            out[row, 0] = self.bos_id
            out[row, 1 : 1 + len(ids)] = ids
            out[row, 1 + len(ids)] = self.eos_id
        return out

    def decode(self, ids) -> List[str]:
        """Batch decode, skipping special tokens (HF batch_decode parity)."""
        ids = np.atleast_2d(np.asarray(ids))
        texts = []
        for row in ids:
            toks = [
                self.decoder.get(int(i), "")
                for i in row
                if int(i) not in (self.bos_id, self.eos_id)
            ]
            text = "".join(toks)
            raw = bytearray(self.byte_decoder[c] for c in text)
            texts.append(
                raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
            )
        return texts


def get_tokenizer(path: str | None = None):
    """First-party BPE tokenizer from local vocab/merges data, else fallback.

    ``path`` may point at an SD checkpoint dir (with a tokenizer/ subdir) or
    directly at a dir holding vocab.json + merges.txt. When no vocab data is
    available the hash fallback engages; callers should surface
    ``tokenizer.is_fallback`` prominently (the drivers do).

    Unlike ddpo_tpu's, this port never asks transformers for a tokenizer:
    that would read a hub cache outside the checkout, and its "not found"
    case can hand back a tokenizer with an unbounded model_max_length.
    """
    if path is not None:
        try:
            return CLIPBPETokenizer.from_dir(path)
        except (OSError, ValueError, KeyError):
            pass
    tok = HashTokenizer()
    if path is not None:
        logging.getLogger(__name__).warning(
            "no tokenizer vocab found under %r - falling back to the hash "
            "tokenizer (token ids will NOT match real CLIP; text "
            "conditioning is meaningless for pretrained checkpoints)",
            path,
        )
    return tok


def warn_if_fallback(tokenizer, where: str = "driver") -> None:
    """Prominent stderr warning when the hash fallback is active.

    The fallback keeps systems tests/benchmarks running without vocab data,
    but silently produces garbage conditioning for real checkpoints —
    reference behavior is always a real CLIPTokenizer
    (pipeline_flax_stable_diffusion.py:148-161).
    """
    if getattr(tokenizer, "is_fallback", False):
        banner = (
            f"[ {where} ] " + "=" * 64 + "\n"
            f"[ {where} ] WARNING: hash-fallback tokenizer active (no BPE "
            "vocab found).\n"
            f"[ {where} ] Token ids will not match CLIP; prompts do not "
            "meaningfully\n"
            f"[ {where} ] condition a pretrained model. Provide vocab.json/"
            "merges.txt\n"
            f"[ {where} ] under the model path to fix.\n"
            f"[ {where} ] " + "=" * 64
        )
        print(banner, flush=True)


def make_uncond_ids(tokenizer, batch_size: int) -> np.ndarray:
    """Token ids for the empty (unconditional) prompt, repeated batch_size x.

    Reference: ddpo/datasets/bucket.py:66-73.
    """
    return tokenizer([""] * batch_size)
