"""Phrase segmentation state machine (host only, numpy).

- **PTT hold**: while push-to-talk is held, every chunk is buffered;
  release triggers processing.
- **Streaming**: VAD-gated. Speech onset pulls in a pre-roll deque
  (10 chunks); each silent chunk increments a counter (silent chunks are
  still buffered once a phrase is open, so the phrase keeps its trailing
  context); counter > 15 (~500 ms) triggers processing.
- **Non-VAD modes** (morse/text): the caller passes every chunk as speech.
- Phrases shorter than ``min_phrase_samples`` (9216) are dropped.

Callers push ``(chunk, is_speech)`` and get back an event with the
completed phrase, if any. One instance per session.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from janus_tpu_torch.common.config import SegmenterConfig

__all__ = ["PhraseSegmenter", "SegmenterEvent"]


class SegmenterEvent(Enum):
    NONE = "none"
    PHRASE_START = "phrase_start"
    PHRASE_READY = "phrase_ready"
    PHRASE_DROPPED = "phrase_dropped"  # triggered but below min length


@dataclass
class _Result:
    event: SegmenterEvent
    phrase: Optional[np.ndarray] = None


class PhraseSegmenter:
    def __init__(self, cfg: Optional[SegmenterConfig] = None) -> None:
        self.cfg = cfg or SegmenterConfig()
        self._pre_roll: deque = deque(maxlen=self.cfg.pre_roll_chunks)
        self._buffer: list = []
        self._silence = 0
        self._ptt_held = False

    # -- properties --------------------------------------------------------

    @property
    def is_open(self) -> bool:
        """A phrase is currently being accumulated."""
        return len(self._buffer) > 0

    @property
    def ptt_held(self) -> bool:
        return self._ptt_held

    @property
    def buffered_samples(self) -> int:
        return sum(len(c) for c in self._buffer)

    # -- PTT path ----------------------------------------------------------

    def push_ptt(self, chunk: np.ndarray, held: bool) -> _Result:
        """Push-to-talk: buffer while held, trigger on release (the
        release chunk itself is not buffered)."""
        if held:
            started = not self._ptt_held
            self._buffer.append(chunk)
            self._ptt_held = True
            return _Result(SegmenterEvent.PHRASE_START if started else SegmenterEvent.NONE)
        if self._ptt_held:
            self._ptt_held = False
            return self._trigger()
        return _Result(SegmenterEvent.NONE)

    # -- streaming path ----------------------------------------------------

    def push_streaming(self, chunk: np.ndarray, is_speech: bool) -> _Result:
        """VAD-gated streaming."""
        if is_speech:
            started = False
            if not self._buffer:
                self._buffer.extend(self._pre_roll)
                started = True
            self._buffer.append(chunk)
            self._silence = 0
            return _Result(SegmenterEvent.PHRASE_START if started else SegmenterEvent.NONE)

        self._silence += 1
        if self._buffer:
            self._buffer.append(chunk)
        else:
            self._pre_roll.append(chunk)
        if self._silence > self.cfg.silence_threshold_chunks and self._buffer:
            return self._trigger()
        return _Result(SegmenterEvent.NONE)

    # -- shared ------------------------------------------------------------

    def _trigger(self) -> _Result:
        combined = np.concatenate(self._buffer) if self._buffer else np.empty(0, np.float32)
        self._buffer = []
        self._silence = 0
        if combined.shape[0] < self.cfg.min_phrase_samples:
            return _Result(SegmenterEvent.PHRASE_DROPPED)
        return _Result(SegmenterEvent.PHRASE_READY, phrase=combined)

    def flush(self) -> _Result:
        """Force-trigger whatever is buffered (e.g. on shutdown)."""
        if not self._buffer:
            return _Result(SegmenterEvent.NONE)
        return self._trigger()

    def reset(self) -> None:
        self._pre_roll.clear()
        self._buffer = []
        self._silence = 0
        self._ptt_held = False
