"""Byte-level BPE (GPT-2's, as OPT and BLIP-2 opt-2.7b use it).

Port of what transformers' GPT2TokenizerFast does with a tokenizer
directory (vocab.json, merges.txt, added_tokens.json,
special_tokens_map.json, tokenizer_config.json):

- encode: the text splits first at the added tokens (``<image>``,
  ``</s>``, ...), longest first; each other piece splits by GPT-2's
  pre-tokenizer pattern (``GPT2_PATTERN``, through ``regex``), each
  part's UTF-8 bytes map to GPT-2's byte characters and merge by the
  merges' ranks; ``add_bos_token`` puts the bos id first;
  ``padding="longest"`` pads on the right with the pad id and a mask of 0.
- decode: ids outside the vocabulary and, with ``skip_special_tokens``,
  the special tokens are dropped; the rest map back to bytes (a token with
  a character outside the byte map gives its own UTF-8 bytes) and the
  bytes of the whole row decode as UTF-8 with U+FFFD for bad sequences;
  ``clean_up_tokenization_spaces`` applies transformers' clean-up.

The byte map and the merge loop are models/tokenizer.py's (CLIP's BPE,
which lower-cases and ends words with ``</w>``). Every BLIP-2 OPT
tokenizer pads on the right; ``padding_side="left"`` is refused.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ddpo_torch.models.tokenizer import bytes_to_unicode, bpe_merge

GPT2_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@lru_cache(maxsize=1)
def _pre_tokenizer():
    import regex

    return regex.compile(GPT2_PATTERN)


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token_content(value) -> Optional[str]:
    if value is None or isinstance(value, str):
        return value
    for flag in ("lstrip", "rstrip", "single_word"):
        if value.get(flag):
            raise NotImplementedError(f"added token {value['content']!r} sets {flag}: not ported")
    return value["content"]


def _read_json(path: str, default):
    if not os.path.exists(path):
        return default
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class GPT2BPETokenizer:
    """``encode`` and ``batch_decode`` of a byte-level BPE directory."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added: Dict[str, int], special: Sequence[str], bos_token: Optional[str],
                 pad_token: Optional[str], add_bos_token: bool = False,
                 clean_up_tokenization_spaces: bool = False):
        self.encoder = dict(vocab)
        self.encoder.update(added)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        # the text splits at every added or special token, longest first
        self.split_tokens = sorted(set(added) | set(special), key=len, reverse=True)
        self.special_ids = {self.encoder[t] for t in special if t in self.encoder}
        self.bos_id = self.encoder[bos_token] if bos_token is not None else None
        self.pad_id = self.encoder[pad_token] if pad_token is not None else None
        self.add_bos_token = add_bos_token
        self.clean_up = clean_up_tokenization_spaces
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "GPT2BPETokenizer":
        for name in ("vocab.json", "merges.txt"):
            if not os.path.exists(os.path.join(path, name)):
                raise FileNotFoundError(f"no {name} under {path}")
        vocab = _read_json(os.path.join(path, "vocab.json"), None)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")]
        config = _read_json(os.path.join(path, "tokenizer_config.json"), {})
        if config.get("padding_side", "right") != "right":
            raise NotImplementedError(f"padding_side {config['padding_side']!r} is not ported "
                                      "(only 'right')")
        special_map = _read_json(os.path.join(path, "special_tokens_map.json"), {})
        added = {t: i for t, i in _read_json(os.path.join(path, "added_tokens.json"), {}).items()
                 if t not in vocab}
        special = []
        for i, entry in config.get("added_tokens_decoder", {}).items():
            content = _token_content(entry)
            if content not in vocab:
                added.setdefault(content, int(i))
            if entry.get("special"):
                special.append(content)
        names = {}
        for source in (config, special_map):
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                if source.get(key) is not None:
                    names[key] = _token_content(source[key])
            for token in source.get("additional_special_tokens", []):
                special.append(_token_content(token))
        special += list(names.values())
        for token in special:
            if token not in vocab and token not in added:
                raise ValueError(f"special token {token!r} is in neither vocab.json nor the "
                                 "added tokens")
        return cls(vocab, merges, added, special, names.get("bos_token"), names.get("pad_token"),
                   add_bos_token=bool(config.get("add_bos_token", False)),
                   clean_up_tokenization_spaces=bool(config.get("clean_up_tokenization_spaces",
                                                                False)))

    def __len__(self) -> int:
        return len(self.encoder)

    def token_id(self, token: str) -> int:
        return self.encoder[token]

    def _bpe(self, word: str) -> List[str]:
        if word not in self._cache:
            self._cache[word] = bpe_merge(word, self.ranks)
        return self._cache[word]

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        pieces = [(text, False)]
        for token in self.split_tokens:
            out = []
            for piece, is_added in pieces:
                if is_added or token not in piece:
                    out.append((piece, is_added))
                    continue
                for j, part in enumerate(piece.split(token)):
                    if j:
                        out.append((token, True))
                    if part:
                        out.append((part, False))
            pieces = out
        return pieces

    def encode_one(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.bos_id] if add_special_tokens and self.add_bos_token else []
        for piece, is_added in self._split_added(text):
            if is_added:
                ids.append(self.encoder[piece])
                continue
            for word in _pre_tokenizer().findall(piece):
                chars = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                ids += [self.encoder[t] for t in self._bpe(chars)]
        return ids

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention_mask), (N, longest) int64, padded on the right
        to the longest row."""
        rows = [self.encode_one(t) for t in texts]
        longest = max(len(r) for r in rows)
        ids = np.full((len(rows), longest), self.pad_id if self.pad_id is not None else 0, np.int64)
        mask = np.zeros((len(rows), longest), np.int64)
        for i, row in enumerate(rows):
            if self.pad_id is None and len(row) < longest:
                raise ValueError("padding needs a pad token")
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        data = bytearray()
        for i in ids:
            token = self.decoder.get(int(i))
            if token is None or (skip_special_tokens and int(i) in self.special_ids):
                continue
            if all(c in self.byte_decoder for c in token):
                data += bytes(self.byte_decoder[c] for c in token)
            else:
                data += token.encode("utf-8")
        text = data.decode("utf-8", errors="replace")
        return clean_up_tokenization(text) if self.clean_up else text

    def batch_decode(self, rows, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in rows]
