"""Batched multi-session runtime: continuous batching for serving.

The reference serves exactly one full-duplex session per process
(reference: backend/server.py:69-84). This runtime serves N concurrent
sessions per host by keeping the per-session control state host-side
(segmenters, VAD floors, queues — cheap) and funneling all heavy compute
through *batched* device work on the encoder's device:

- every tick, one VAD pass scores the newest chunk of every active
  session at once (the chunks are stacked and copied to the device once;
  48→16 kHz decimation and the energy gate, or the learned model, run
  there; the host reads the result one tick later under
  ``runtime.pipelined_vad``);
- phrases completed by any session on the same tick are encoded together
  in one ``SemanticEncoder.encode_batch_submit`` call (shared duration
  bucket).

Chunks ride the native SPSC ring buffers (:mod:`janus_tpu_torch.native`)
from capture threads into the tick loop, so the Python-side cost per
session-tick is a few dict operations.

Runtime overlap: encodes are submitted (``encode_batch_submit``, whose
handle polls a CUDA event) and harvested on later ticks once the device
reports them done, so batch N's encode can run on the card while the host
drains rings and runs VAD/segmentation for batch N+1.
``runtime.max_inflight_encodes`` bounds the window (0 = synchronous);
``flush()`` drains it at stream end / pre-snapshot.

The same semantics as ``janus_tpu.runtime.sessions``: FIFO harvest, the
per-session failure-isolation ladder, the snapshot spill budget.
``SessionManager`` builds its own encoder on ``device`` (the card unless
the caller asks for ``"cpu"``); given an encoder, it runs on that
encoder's device.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.models.params import tree_to
from janus_tpu_torch.models.vad import energy_gate_prob, vad_model_prob
from janus_tpu_torch.native import RingBuffer
from janus_tpu_torch.ops.resample import decimate_48k_to_16k
from janus_tpu_torch.runtime.codec import PendingEncode, SemanticEncoder
from janus_tpu_torch.runtime.emotion import api_mode_to_protocol
from janus_tpu_torch.runtime.segmenter import PhraseSegmenter, SegmenterEvent

logger = logging.getLogger(__name__)

__all__ = ["Session", "SessionManager"]


@dataclass
class Session:
    """Host-side state for one duplex voice session."""

    session_id: str
    segmenter: PhraseSegmenter
    ring: RingBuffer
    mode: str = "semantic"
    override_emotion: str = "Auto"
    is_streaming: bool = True
    packets_out: List[JanusPacket] = field(default_factory=list)
    vad_floor: float = 1e-3
    chunks_in: int = 0
    phrases_encoded: int = 0
    # snapshot-in-progress state: while paused, push_audio diverts into the
    # bounded spill list (drained back into the ring, in order, when the
    # snapshot finishes) so a 32 ms-cadence capture thread loses nothing.
    paused: bool = False
    spill: List[np.ndarray] = field(default_factory=list)
    spill_budget: int = 0  # samples the spill may still accept
    lock: "threading.Lock" = field(default_factory=lambda: threading.Lock())


class SessionManager:
    """Owns N sessions and drives batched ticks."""

    def __init__(
        self,
        cfg: Optional[JanusConfig] = None,
        encoder: Optional[SemanticEncoder] = None,
        on_packet: Optional[Callable[[str, JanusPacket], None]] = None,
        vad_params=None,
        device="cuda",
    ) -> None:
        self.cfg = cfg or JanusConfig()
        self.encoder = encoder or SemanticEncoder(self.cfg, device=device)
        self.device = self.encoder.device
        self.on_packet = on_packet
        self.sessions: Dict[str, Session] = {}
        # batched VAD: the learned spectral model when configured (and
        # weights supplied), else the adaptive energy gate
        self._vad_params = (None if vad_params is None
                            else tree_to(vad_params, self.device))
        self._use_model_vad = (
            self.cfg.vad.backend == "model" and vad_params is not None
        )
        self._chunk = self.cfg.audio.chunk_samples
        # Runtime overlap: encodes submitted but not yet harvested. FIFO
        # preserves per-session packet order.
        self._inflight: "deque[Tuple[List[Tuple[Session, np.ndarray]], PendingEncode]]" = deque()
        # Double-buffered VAD: (sessions, chunks, device prob/floor tensors)
        # dispatched last tick, consumed this tick.
        self._vad_inflight: Optional[Tuple[List[Session], List[np.ndarray], tuple]] = None

    # -- session lifecycle -------------------------------------------------

    def add_session(self, session_id: str, mode: str = "semantic") -> Session:
        if session_id in self.sessions:
            raise KeyError(f"duplicate session {session_id}")
        if len(self.sessions) >= self.cfg.runtime.max_sessions:
            raise RuntimeError("session limit reached")
        ring_cap = self._chunk * self.cfg.runtime.audio_queue_depth
        s = Session(
            session_id=session_id,
            segmenter=PhraseSegmenter(self.cfg.segmenter),
            ring=RingBuffer(ring_cap),
            mode=mode,
        )
        self.sessions[session_id] = s
        return s

    def remove_session(self, session_id: str) -> None:
        self.sessions.pop(session_id, None)

    # -- ingestion (called from capture/socket threads) --------------------

    def push_audio(self, session_id: str, samples: np.ndarray) -> bool:
        """Thread-safe: feed capture samples into the session's ring.

        A snapshot in progress does NOT reject audio: samples divert into
        a bounded spill list (budgeted to the ring space that existed at
        pause time, so the post-snapshot drain always fits) and are pushed
        back in order when the snapshot completes. False means genuine
        backpressure — the ring (or the spill budget standing in for it)
        is full — exactly as in normal operation."""
        s = self.sessions[session_id]
        with s.lock:
            if s.paused:
                samples = np.ascontiguousarray(samples, dtype=np.float32)
                if samples.shape[0] > s.spill_budget:
                    return False
                s.spill.append(samples.copy())
                s.spill_budget -= samples.shape[0]
                return True
            return s.ring.push(samples)

    # -- the batched tick --------------------------------------------------

    def tick(self) -> List[Tuple[str, JanusPacket]]:
        """Drain one chunk per session, run batched VAD + segmentation, and
        encode every completed phrase in one batch. Returns the packets
        produced this tick (also delivered via ``on_packet``).

        With ``runtime.pipelined_vad`` (default) the VAD pass for this
        tick's chunks is launched and the PREVIOUS tick's result is
        consumed, so the device→host read of batch N overlaps the launch
        of batch N+1; encodes likewise submit here and harvest on a later
        tick (``runtime.max_inflight_encodes``)."""
        active: List[Session] = []
        chunks: List[np.ndarray] = []
        for s in self.sessions.values():
            if not s.is_streaming:
                continue
            chunk = s.ring.pop(self._chunk)
            if chunk is None:
                continue
            s.chunks_in += 1
            active.append(s)
            chunks.append(chunk)

        if self.cfg.runtime.pipelined_vad:
            dispatched = (
                (active, chunks, self._dispatch_vad(chunks, active))
                if active else None
            )
            scored, self._vad_inflight = self._vad_inflight, dispatched
        else:
            scored = (active, chunks, self._dispatch_vad(chunks, active)) \
                if active else None

        phrases = self._consume_vad(scored)

        if phrases:
            # Runtime overlap: SUBMIT the encode and return to the tick
            # loop — batch N runs on the device while the host drains
            # chunks and runs VAD/segmentation for batch N+1. Harvest happens below, only when the device is done (or
            # when the in-flight window fills: bounded memory, natural
            # backpressure).
            self._inflight.append((phrases, self._submit_isolated(phrases)))

        out: List[Tuple[str, JanusPacket]] = []
        max_inflight = self.cfg.runtime.max_inflight_encodes
        while self._inflight and self._inflight[0][1].is_ready():
            out.extend(self._harvest_oldest())
        while len(self._inflight) > max_inflight:  # blocking backpressure
            out.extend(self._harvest_oldest())
        return out

    def flush(self) -> List[Tuple[str, JanusPacket]]:
        """Drain both pipeline stages — consume the in-flight VAD batch
        (which may complete phrases and dispatch a final encode) and then
        block-harvest every dispatched encode. Use at end of stream,
        pre-snapshot, or in tests wanting synchronous semantics."""
        scored, self._vad_inflight = self._vad_inflight, None
        phrases = self._consume_vad(scored)
        if phrases:
            self._inflight.append((phrases, self._submit_isolated(phrases)))
        out: List[Tuple[str, JanusPacket]] = []
        while self._inflight:
            out.extend(self._harvest_oldest())
        return out

    @torch.no_grad()
    def _dispatch_vad(self, chunks: List[np.ndarray],
                      active: List[Session]) -> tuple:
        """Launch one batched VAD pass scoring every session's newest
        chunk; returns DEVICE tensors (probs, new_floors) — no host sync.
        Under pipelining the energy-gate floor a dispatch sees is one tick
        stale (its update lands at harvest); the floor is an EMA, so the
        one-chunk lag is immaterial. (Autograd off inside the method: grad
        mode is thread-local, and a server may tick from any thread.)"""
        batch = torch.from_numpy(np.stack(chunks)).to(self.device)
        floors = torch.from_numpy(
            np.asarray([s.vad_floor for s in active], np.float32)
        ).to(self.device)
        chunk_16k = decimate_48k_to_16k(batch)
        if self._use_model_vad:
            return vad_model_prob(self._vad_params, chunk_16k), floors
        return energy_gate_prob(chunk_16k, floors, self.cfg.vad.energy_gate_rms)

    def _consume_vad(self, scored) -> List[Tuple[Session, np.ndarray]]:
        """Host-sync a dispatched VAD batch and run segmentation on it."""
        phrases: List[Tuple[Session, np.ndarray]] = []
        if scored is None:
            return phrases
        v_sessions, v_chunks, v_arrays = scored
        probs, new_floors = (a.cpu().numpy() for a in v_arrays)
        for s, chunk, p, fl in zip(v_sessions, v_chunks, probs, new_floors):
            if s.session_id not in self.sessions:
                continue  # removed while its VAD was in flight
            s.vad_floor = float(fl)
            non_vad = s.mode in ("morse", "text_only")
            is_speech = non_vad or (p > self.cfg.vad.threshold)
            r = s.segmenter.push_streaming(chunk, is_speech)
            if r.event is SegmenterEvent.PHRASE_READY:
                phrases.append((s, r.phrase))
        return phrases

    def _submit_isolated(self, phrases: List[Tuple[Session, np.ndarray]]
                         ) -> PendingEncode:
        """Dispatch the batched encode; dispatch-time failures degrade to
        a synchronous per-phrase pass immediately."""
        try:
            return self.encoder.encode_batch_submit([p for _, p in phrases])
        except Exception as e:
            logger.error("batched encode dispatch failed (%s); isolating", e)
            return PendingEncode.done(self._encode_per_phrase(phrases))

    def _harvest_oldest(self) -> List[Tuple[str, JanusPacket]]:
        """Pop the oldest in-flight encode (FIFO keeps per-session packet
        order), with the per-session failure-isolation ladder: if the
        batched encode fails at completion, re-encode one phrase at a
        time so a poisoned session degrades alone (the batched analog of
        the reference's per-stage try/except ladder; reference:
        backend/services/engine.py:510-526)."""
        phrases, pending = self._inflight.popleft()
        try:
            encoded = pending.result()
        except Exception as e:
            logger.error("batched encode failed (%s); isolating per session", e)
            encoded = self._encode_per_phrase(phrases)
        out: List[Tuple[str, JanusPacket]] = []
        for (s, _), res in zip(phrases, encoded):
            s.phrases_encoded += 1
            if res is None or not res["text"].strip():
                continue
            packet = JanusPacket(
                text=res["text"],
                mode=api_mode_to_protocol(s.mode),
                prosody=res["prosody"],
                override_emotion=s.override_emotion,
            )
            s.packets_out.append(packet)
            out.append((s.session_id, packet))
            if self.on_packet is not None:
                self.on_packet(s.session_id, packet)
        return out

    def _encode_per_phrase(self, phrases: List[Tuple[Session, np.ndarray]]) -> List:
        results: List = []
        for s, phrase in phrases:
            try:
                results.append(self.encoder.encode_batch([phrase])[0])
            except Exception as e:
                logger.error("session %s encode failed: %s", s.session_id, e)
                results.append(None)
        return results

    def run(self, stop_check: Callable[[], bool], tick_sleep: float = 0.0) -> int:
        """Tick until ``stop_check()`` is True; returns packets produced
        (including a final flush of in-flight encodes)."""
        total = 0
        while not stop_check():
            total += len(self.tick())
            if tick_sleep:
                time.sleep(tick_sleep)
        total += len(self.flush())
        return total

    # -- checkpoint / resume -----------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        """Serializable snapshot of per-session streaming state (segmenter
        buffers, pre-roll, VAD floor, control fields, undrained ring audio)
        — the serving analog of model checkpointing, enabling live session
        migration/restart (SURVEY.md §5: checkpoint/resume was absent in
        the reference)."""
        self.flush()  # in-flight encodes belong to the pre-snapshot epoch
        snap: Dict[str, Dict] = {}
        for sid, s in self.sessions.items():
            # Pause ingestion so the drain/refill below is atomic w.r.t.
            # concurrent push_audio. Capture threads keep landing audio in
            # the bounded spill (sized to the ring space free at pause
            # time), which drains back into the ring, in order, below —
            # a 32 ms capture cadence loses nothing across a snapshot.
            ring_cap = self._chunk * self.cfg.runtime.audio_queue_depth
            with s.lock:
                s.paused = True
                s.spill_budget = max(0, ring_cap - len(s.ring))
            try:
                ring_audio = s.ring.pop(len(s.ring)) if len(s.ring) else None
            finally:
                with s.lock:
                    if ring_audio is not None and not s.ring.push(ring_audio):
                        # cannot happen (ring was just drained), but never
                        # lose audio silently
                        logger.error("ring refill failed for %s", sid)
                    for spilled in s.spill:
                        if not s.ring.push(spilled):
                            logger.error("spill drain overflow for %s", sid)
                    s.spill.clear()
                    s.paused = False
            seg = s.segmenter
            snap[sid] = {
                "mode": s.mode,
                "override_emotion": s.override_emotion,
                "is_streaming": s.is_streaming,
                "vad_floor": s.vad_floor,
                "chunks_in": s.chunks_in,
                "phrases_encoded": s.phrases_encoded,
                "segmenter": {
                    "pre_roll": [c.tolist() for c in seg._pre_roll],
                    "buffer": [c.tolist() for c in seg._buffer],
                    "silence": seg._silence,
                    "ptt_held": seg._ptt_held,
                },
                "ring_audio": ring_audio.tolist() if ring_audio is not None else None,
            }
        return snap

    def restore(self, snap: Dict[str, Dict]) -> None:
        """Rebuild sessions from :meth:`snapshot`."""
        for sid, st in snap.items():
            s = self.add_session(sid, mode=st["mode"])
            s.override_emotion = st["override_emotion"]
            s.is_streaming = st["is_streaming"]
            s.vad_floor = st["vad_floor"]
            s.chunks_in = st["chunks_in"]
            s.phrases_encoded = st["phrases_encoded"]
            seg = s.segmenter
            for c in st["segmenter"]["pre_roll"]:
                seg._pre_roll.append(np.asarray(c, dtype=np.float32))
            seg._buffer = [np.asarray(c, dtype=np.float32)
                           for c in st["segmenter"]["buffer"]]
            seg._silence = st["segmenter"]["silence"]
            seg._ptt_held = st["segmenter"]["ptt_held"]
            if st["ring_audio"]:
                s.ring.push(np.asarray(st["ring_audio"], dtype=np.float32))

    # -- introspection -----------------------------------------------------

    @property
    def inflight_encodes(self) -> int:
        """Encodes submitted but not yet harvested."""
        return len(self._inflight)

    def stats(self) -> Dict[str, Dict]:
        return {
            sid: {
                "chunks_in": s.chunks_in,
                "phrases_encoded": s.phrases_encoded,
                "packets": len(s.packets_out),
                "buffered_samples": len(s.ring),
            }
            for sid, s in self.sessions.items()
        }
