"""Text tokenizers (host side; the models only ever see integer id tensors).

- :class:`ByteTokenizer`: the framework default. 256 byte ids + specials,
  no assets, no OOV.
- :class:`BpeTokenizer`: GPT-2-style byte-level BPE over a ``vocab.json`` +
  ``merges.txt`` pair, so Whisper-family checkpoints drop in with their own
  vocabulary and a multi-token ``sot_sequence``.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["SpecialTokens", "ByteTokenizer", "BpeTokenizer"]


class SpecialTokens:
    """Reserved control ids appended after the base vocabulary."""

    def __init__(self, base_vocab: int):
        self.sot = base_vocab + 0        # start of transcript
        self.eot = base_vocab + 1        # end of transcript / end of text
        self.pad = base_vocab + 2
        self.task_transcribe = base_vocab + 3
        self.no_timestamps = base_vocab + 4
        self.count = 5


class ByteTokenizer:
    """UTF-8 byte tokenizer: id i < 256 is byte i; specials follow."""

    def __init__(self) -> None:
        self.specials = SpecialTokens(256)
        self.vocab_size = 256 + self.specials.count

    @property
    def sot(self) -> int:
        return self.specials.sot

    @property
    def eot(self) -> int:
        return self.specials.eot

    @property
    def pad(self) -> int:
        return self.specials.pad

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def sot_sequence(self) -> List[int]:
        return [self.sot]


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte↔unicode table (printable surrogates for
    control bytes)."""
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


class BpeTokenizer:
    """Byte-level BPE over a ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 sot: int | None = None, eot: int | None = None):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.vocab_size = max(self.encoder.values()) + 1
        self.eot = (eot if eot is not None else
                    self.encoder.get("<|endoftext|>", self.vocab_size - 1))
        self.sot = (sot if sot is not None else
                    self.encoder.get("<|startoftranscript|>", self.eot))
        self.pad = self.eot

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "BpeTokenizer":
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @functools.lru_cache(maxsize=65536)
    def _bpe(self, token: str) -> Tuple[str, ...]:
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return word

    def encode(self, text: str) -> List[int]:
        surrogate = "".join(self.byte_encoder[b]
                            for b in text.encode("utf-8"))
        out: List[int] = []
        # Whisper/GPT-2 pre-tokenize with a regex; splitting on spaces while
        # keeping the leading-space convention is a close, dependency-free
        # approximation adequate for transcript text.
        pieces: List[str] = []
        cur = ""
        space = self.byte_encoder[ord(" ")]
        for ch in surrogate:
            if ch == space and cur:
                pieces.append(cur)
                cur = ch
            else:
                cur += ch
        if cur:
            pieces.append(cur)
        for piece in pieces:
            for sub in self._bpe(piece):
                if sub in self.encoder:
                    out.append(self.encoder[sub])
                else:
                    out.extend(self.encoder.get(c, 0) for c in sub)
        return out

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self.byte_decoder[c] for c in text
                     if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def sot_sequence(self) -> List[int]:
        seq = [self.sot]
        for name in ("<|en|>", "<|transcribe|>", "<|notimestamps|>"):
            if name in self.encoder:
                seq.append(self.encoder[name])
        return seq
