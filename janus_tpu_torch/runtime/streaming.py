"""Streaming incremental transcription.

Live partial transcripts while the speaker is still talking: audio
accumulates, and every ``stride`` seconds the most recent ``window``
seconds are encoded again through the same bucketed encode, giving a
growing hypothesis. Windows overlap by ``window − stride``, and the
*final* transcript still comes from the full-phrase encode, so streaming
never changes the final result.

Within a window the hypothesis is stitched to the committed prefix by the
longest suffix/prefix word overlap: cheap and adequate for partials,
which are UI hints (the wire packet always carries the final encode).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from janus_tpu_torch.runtime.codec import SemanticEncoder

__all__ = ["StreamingTranscriber", "merge_transcripts"]


def merge_transcripts(committed: str, hypothesis: str) -> str:
    """Stitch a window hypothesis onto committed text via the longest
    word-level suffix(committed)/prefix(hypothesis) overlap."""
    if not committed:
        return hypothesis
    if not hypothesis:
        return committed
    c_words = committed.split()
    h_words = hypothesis.split()
    best = 0
    for k in range(min(len(c_words), len(h_words)), 0, -1):
        if c_words[-k:] == h_words[:k]:
            best = k
            break
    return " ".join(c_words + h_words[best:])


class StreamingTranscriber:
    """Incremental partial transcripts over a growing phrase."""

    def __init__(
        self,
        encoder: SemanticEncoder,
        window_seconds: float = 4.0,
        stride_seconds: float = 1.0,
        sample_rate: int = 48_000,
        max_phrase_seconds: float = 120.0,
    ) -> None:
        self.encoder = encoder
        self.sample_rate = sample_rate
        self.window = int(window_seconds * sample_rate)
        self.stride = int(stride_seconds * sample_rate)
        self.max_keep = int(max_phrase_seconds * sample_rate)
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        self._since_last = 0
        self._committed_samples = 0  # prefix already transcribed into _committed
        self._committed = ""
        self._partial = ""

    @property
    def partial(self) -> str:
        return self._partial

    def _audio(self) -> np.ndarray:
        return np.concatenate(self._buffer) if self._buffer else np.empty(0, np.float32)

    def push(self, chunk: np.ndarray) -> Optional[str]:
        """Feed one capture chunk; returns an updated partial transcript
        when a stride boundary was crossed, else None.

        Work per stride is O(window + stride): only audio newly aged out
        of the window is transcribed into the committed prefix; the window
        hypothesis covers the rest.
        """
        self._buffer.append(np.asarray(chunk, dtype=np.float32))
        self._buffered += len(chunk)
        # bound memory for pathological phrase lengths (finalize then
        # covers the retained suffix)
        while self._buffered > self.max_keep and len(self._buffer) > 1:
            dropped = self._buffer.pop(0)
            self._buffered -= len(dropped)
            self._committed_samples = max(0, self._committed_samples - len(dropped))
        self._since_last += len(chunk)
        if self._since_last < self.stride:
            return None
        self._since_last = 0

        audio = self._audio()
        commit_target = max(0, len(audio) - self.window)
        if commit_target - self._committed_samples >= self.stride:
            # transcribe only the newly aged span
            aged = audio[self._committed_samples : commit_target]
            aged_hyp = self.encoder.encode_batch([aged])[0]["text"]
            self._committed = merge_transcripts(self._committed, aged_hyp)
            self._committed_samples = commit_target
        hyp = self.encoder.encode_batch([audio[commit_target:]])[0]["text"]
        self._partial = merge_transcripts(self._committed, hyp)
        return self._partial

    def finalize(self) -> str:
        """Full-phrase transcript over the retained audio (identical to the
        non-streaming path for phrases within ``max_phrase_seconds``)."""
        if not self._buffer:
            return ""
        final = self.encoder.encode_batch([self._audio()])[0]["text"]
        self.reset()
        return final

    def reset(self) -> None:
        self._buffer = []
        self._buffered = 0
        self._since_last = 0
        self._committed_samples = 0
        self._committed = ""
        self._partial = ""
