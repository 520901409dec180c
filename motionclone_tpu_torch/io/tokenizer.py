"""CLIP BPE tokenizer from a checkpoint's ``tokenizer/vocab.json`` and
``tokenizer/merges.txt``, with the standard library only.

Port of ``motionclone_tpu/io/tokenizer.py``, which gives Hugging Face
``CLIPTokenizer``'s ids (its no-ftfy path):

- text normalisation: control characters removed, whitespace folded, CJK
  ideographs spaced, NFC, whitespace split, lowercase (accents kept,
  punctuation not split);
- the CLIP token pattern
  ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
  (case-insensitive), here a scanner over ``unicodedata.category``: a run
  of letters (L*), one number (N*: Nd, Nl and No alike, so ``²``, ``½`` and
  ``Ⅻ`` are numbers, as ``\\p{N}`` has them and ``re``'s ``\\w`` does not),
  whitespace skipped, a run of anything else;
- byte-level BPE with ``</w>`` end-of-word markers, the merges table cut
  to CLIP's budget (49152 - 256 - 2 rows after the version header);
- encode: ``<|startoftext|> X <|endoftext|>``, truncated to keep the head,
  padded with the eos id.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
# the pattern's literal alternatives, tried first and in this order
_LITERALS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
                       re.IGNORECASE)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte<->unicode table (printable ranges map to
    themselves; remaining bytes map above U+0100)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in ("\t", "\n", "\r") and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _normalize(text: str) -> str:
    """Clean, CJK-space, NFC, whitespace-split, lowercase, rejoin."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(" " + ch + " ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    text = unicodedata.normalize("NFC", "".join(cleaned))
    return " ".join(tok.lower() for tok in text.split())


def _char_class(ch: str) -> str:
    """'L' (letter), 'N' (number), 'S' (whitespace) or 'O' (anything else)."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "O"


def split_tokens(text: str) -> List[str]:
    """The CLIP token pattern's matches in ``text``, left to right."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERALS.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        if cls == "N":
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _char_class(text[j]) == cls:
            j += 1
        out.append(text[i:j])
        i = j
    return out


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word, word[1:]))


class ClipTokenizer:
    """The subset of ``CLIPTokenizer`` the runtime uses."""

    model_max_length = 77

    def __init__(self, vocab_file: str, merges_file: str, pad_token: Optional[str] = None):
        with open(vocab_file, encoding="utf-8") as fh:
            self.encoder: Dict[str, int] = json.load(fh)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as fh:
            lines = fh.read().strip().split("\n")[1: 49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(line.split()): i for i, line in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {BOS: BOS, EOS: EOS}
        self.bos_token_id = self.encoder[BOS]
        self.eos_token_id = self.encoder[EOS]
        # EOS pads unless the tokenizer names another pad (SDXL's second: "!", id 0)
        self.pad_token_id = self.eos_token_id if pad_token is None else self.encoder[pad_token]
        self.unk_token_id = self.eos_token_id

    @classmethod
    def from_pretrained(cls, model_path: str, subfolder: str = "tokenizer"):
        """The tokenizer of a diffusers-layout subfolder, with the pad token
        its ``special_tokens_map.json`` names, where it has one."""
        base = os.path.join(model_path, subfolder) if subfolder else model_path
        pad = None
        special = os.path.join(base, "special_tokens_map.json")
        if os.path.isfile(special):
            with open(special, encoding="utf-8") as fh:
                pad = json.load(fh).get("pad_token")
            pad = pad.get("content") if isinstance(pad, dict) else pad
        return cls(os.path.join(base, "vocab.json"), os.path.join(base, "merges.txt"), pad)

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
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
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
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
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for token in split_tokens(_normalize(text)):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            toks.extend(self._bpe(mapped).split(" "))
        return toks

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        """bos + bpe ids + eos, head-truncated to ``max_length``."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))[: max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def encode_padded(self, text: str, max_length: int = 77) -> np.ndarray:
        """(1, max_length) int32 ids, padded with the pad id (EOS's by
        default)."""
        ids = self.encode(text, max_length=max_length)
        ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return np.asarray([ids], dtype=np.int32)

    def decode(self, ids) -> str:
        toks = [self.decoder.get(int(i), EOS) for i in ids]
        text = "".join(t for t in toks if t not in (BOS, EOS))
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()
