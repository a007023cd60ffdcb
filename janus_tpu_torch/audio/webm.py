"""Pure-Python WebM (Matroska/EBML) demux/mux for Opus audio.

The browser's MediaRecorder records voice-clone clips as
``audio/webm;codecs=opus`` (reference: frontend/components/VoiceCloner.tsx:61-63)
and the reference backend handed them to FFmpeg (reference:
backend/services/transcriber.py:66-91). This module is the first-party
demuxer for that path: a tolerant EBML walk that extracts the Opus
track's metadata (CodecPrivate OpusHead, CodecDelay) and its
SimpleBlock/BlockGroup frames. It handles the streaming quirks
MediaRecorder produces: unknown-size Segment and Cluster elements, and a
recording cut off mid-element.

The mux half builds a minimal spec-shaped WebM file (EBML header →
Segment → Info/Tracks → Clusters of SimpleBlocks) used as the test
fixture standing in for a real browser recording.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence, Tuple

__all__ = ["is_webm", "demux_webm_opus", "mux_webm_opus"]

_EBML_MAGIC = b"\x1a\x45\xdf\xa3"

# Element IDs (with leading length-descriptor bits, as they appear on the wire)
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMECODE_SCALE = 0x2AD7B1
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_CODEC_DELAY = 0x56AA
_AUDIO = 0xE1
_SAMPLING_FREQ = 0xB5
_CHANNELS = 0x9F
_CLUSTER = 0x1F43B675
_CLUSTER_TIMECODE = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1
_SEEK_HEAD = 0x114D9B74
_CUES = 0x1C53BB6B
_TAGS = 0x1254C367
_CHAPTERS = 0x1043A770
_ATTACHMENTS = 0x1941A469

# Masters we descend into during the walk.
_MASTERS = {_SEGMENT, _INFO, _TRACKS, _TRACK_ENTRY, _AUDIO, _CLUSTER, _BLOCK_GROUP}
# IDs that terminate an unknown-size Cluster (any sibling at Segment level).
_SEGMENT_CHILDREN = {
    _INFO, _TRACKS, _CLUSTER, _SEEK_HEAD, _CUES, _TAGS, _CHAPTERS, _ATTACHMENTS,
}

_UNKNOWN = -1


def is_webm(data: bytes) -> bool:
    return data[:4] == _EBML_MAGIC


# -- EBML primitives ---------------------------------------------------------

def _read_id(data: bytes, pos: int) -> Tuple[Optional[int], int]:
    """Read an element ID (1-4 bytes, marker bits kept). -> (id, next_pos)."""
    if pos >= len(data):
        return None, pos
    b0 = data[pos]
    for n in range(1, 5):
        if b0 & (0x80 >> (n - 1)):
            if pos + n > len(data):
                return None, pos
            return int.from_bytes(data[pos : pos + n], "big"), pos + n
    return None, pos  # invalid ID byte


def _read_size(data: bytes, pos: int) -> Tuple[Optional[int], int]:
    """Read an element size vint. -> (size or _UNKNOWN, next_pos)."""
    if pos >= len(data):
        return None, pos
    b0 = data[pos]
    for n in range(1, 9):
        if b0 & (0x80 >> (n - 1)):
            if pos + n > len(data):
                return None, pos
            raw = int.from_bytes(data[pos : pos + n], "big")
            mask = (1 << (7 * n)) - 1
            val = raw & mask
            return (_UNKNOWN if val == mask else val), pos + n
    return None, pos


def _read_vint(data: bytes, pos: int) -> Tuple[Optional[int], int]:
    """Read a block-header vint (track number) — same coding as size."""
    return _read_size(data, pos)


def _uint(payload: bytes) -> int:
    return int.from_bytes(payload, "big") if payload else 0


def _float(payload: bytes) -> float:
    if len(payload) == 4:
        return struct.unpack(">f", payload)[0]
    if len(payload) == 8:
        return struct.unpack(">d", payload)[0]
    return 0.0


def _walk(data: bytes, pos: int, end: int, level_ids: Optional[set] = None
          ) -> Iterator[Tuple[int, int, int]]:
    """Yield (element_id, payload_start, payload_end) from pos to end.

    Unknown-size masters extend to ``end`` unless a member of
    ``level_ids`` (sibling set) appears — the MediaRecorder streaming
    case. Truncated trailing elements are dropped.
    """
    while pos < end:
        eid, p1 = _read_id(data, pos)
        if eid is None:
            return
        size, p2 = _read_size(data, p1)
        if size is None:
            return
        if size == _UNKNOWN:
            payload_end = end
        else:
            payload_end = p2 + size
            if payload_end > end:
                return  # truncated recording
        yield eid, p2, payload_end
        pos = payload_end


def _children(data: bytes, start: int, end: int) -> Iterator[Tuple[int, int, int]]:
    return _walk(data, start, end)


# -- demux -------------------------------------------------------------------

def demux_webm_opus(data: bytes) -> Tuple[dict, List[bytes]]:
    """Extract (track_info, opus_packets) from a WebM/Opus byte string.

    ``track_info`` carries ``pre_skip`` (from CodecPrivate OpusHead when
    present, else CodecDelay ns converted at 48 kHz), ``channels`` and
    ``sample_rate``. Packets are returned in storage order (MediaRecorder
    emits them monotonically).
    """
    if not is_webm(data):
        raise ValueError("not an EBML/WebM stream")

    # Skip the EBML header, find the Segment.
    segment_span = None
    for eid, s, e in _walk(data, 0, len(data)):
        if eid == _SEGMENT:
            segment_span = (s, e)
            break
    if segment_span is None:
        raise ValueError("no Matroska Segment found")

    info = {
        "track_number": None, "channels": 1, "sample_rate": 48_000.0,
        "pre_skip": 0, "timecode_scale": 1_000_000,
    }
    packets: List[bytes] = []

    def parse_track_entry(s: int, e: int) -> None:
        entry = {"number": None, "codec": None, "delay_ns": 0,
                 "private": b"", "channels": 1, "freq": 48_000.0, "type": 0}
        for eid, cs, ce in _children(data, s, e):
            payload = data[cs:ce]
            if eid == _TRACK_NUMBER:
                entry["number"] = _uint(payload)
            elif eid == _TRACK_TYPE:
                entry["type"] = _uint(payload)
            elif eid == _CODEC_ID:
                entry["codec"] = payload.rstrip(b"\x00").decode("ascii", "replace")
            elif eid == _CODEC_PRIVATE:
                entry["private"] = payload
            elif eid == _CODEC_DELAY:
                entry["delay_ns"] = _uint(payload)
            elif eid == _AUDIO:
                for aid, as_, ae in _children(data, cs, ce):
                    if aid == _SAMPLING_FREQ:
                        entry["freq"] = _float(data[as_:ae])
                    elif aid == _CHANNELS:
                        entry["channels"] = _uint(data[as_:ae])
        if entry["codec"] == "A_OPUS" and info["track_number"] is None:
            info["track_number"] = entry["number"]
            info["channels"] = max(1, int(entry["channels"]))
            info["sample_rate"] = float(entry["freq"]) or 48_000.0
            if entry["private"][:8] == b"OpusHead":
                from janus_tpu_torch.audio.opus import parse_opus_head

                head = parse_opus_head(entry["private"])
                info["pre_skip"] = head["pre_skip"]
                info["channels"] = head["channels"]
            elif entry["delay_ns"]:
                info["pre_skip"] = round(entry["delay_ns"] * 48_000 / 1e9)

    def parse_block(s: int, e: int) -> None:
        track, p = _read_vint(data, s)
        if track is None or p + 3 > e:
            return
        # int16 relative timecode + flags byte, then frame data (lacing
        # flags 0x06; MediaRecorder uses no lacing).
        flags = data[p + 2]
        p += 3
        lacing = (flags >> 1) & 0x03
        if info["track_number"] is not None and track != info["track_number"]:
            return
        if lacing == 0:
            packets.append(data[p:e])
            return
        # Lacing: frame count then per-lacing sizes (EBML/Xiph/fixed).
        if p >= e:
            return
        n_frames = data[p] + 1
        p += 1
        sizes: List[int] = []
        if lacing == 2:  # fixed
            total = e - p
            if n_frames and total % n_frames == 0:
                sizes = [total // n_frames] * n_frames
        elif lacing == 1:  # Xiph
            for _ in range(n_frames - 1):
                v = 0
                while p < e:
                    v += data[p]
                    stop = data[p] < 255
                    p += 1
                    if stop:
                        break
                sizes.append(v)
            sizes.append(e - p - sum(sizes))
        else:  # EBML lacing: first size is a vint, rest are signed deltas
            first, p = _read_vint(data, p)
            if first is None:
                return
            sizes = [first]
            for _ in range(n_frames - 2):
                raw, p2 = _read_size(data, p)
                if raw is None:
                    return
                nbytes = p2 - p
                delta = raw - ((1 << (7 * nbytes - 1)) - 1)
                sizes.append(sizes[-1] + delta)
                p = p2
            sizes.append(e - p - sum(sizes))
        for sz in sizes:
            if sz < 0 or p + sz > e:
                return
            packets.append(data[p : p + sz])
            p += sz

    def parse_cluster(s: int, e: int) -> None:
        pos = s
        while pos < e:
            eid, p1 = _read_id(data, pos)
            if eid is None:
                return
            if eid in _SEGMENT_CHILDREN and eid != _CLUSTER and pos != s:
                return  # unknown-size cluster ended at a Segment-level sibling
            if eid == _CLUSTER and pos != s:
                return
            size, p2 = _read_size(data, p1)
            if size is None:
                return
            payload_end = e if size == _UNKNOWN else min(p2 + size, e)
            if size != _UNKNOWN and p2 + size > e:
                return
            if eid == _SIMPLE_BLOCK:
                parse_block(p2, payload_end)
            elif eid == _BLOCK_GROUP:
                for gid, gs, ge in _children(data, p2, payload_end):
                    if gid == _BLOCK:
                        parse_block(gs, ge)
            pos = payload_end

    # First pass: Tracks (so block filtering knows the Opus track number).
    seg_s, seg_e = segment_span
    cluster_spans: List[Tuple[int, int]] = []
    pos = seg_s
    while pos < seg_e:
        eid, p1 = _read_id(data, pos)
        if eid is None:
            break
        size, p2 = _read_size(data, p1)
        if size is None:
            break
        if size == _UNKNOWN:
            payload_end = seg_e
        else:
            payload_end = p2 + size
            if payload_end > seg_e:
                break
        if eid == _INFO:
            for iid, is_, ie in _children(data, p2, payload_end):
                if iid == _TIMECODE_SCALE:
                    info["timecode_scale"] = _uint(data[is_:ie])
        elif eid == _TRACKS:
            for tid, ts, te in _children(data, p2, payload_end):
                if tid == _TRACK_ENTRY:
                    parse_track_entry(ts, te)
        elif eid == _CLUSTER:
            cluster_spans.append((p2, payload_end))
            if size == _UNKNOWN:
                # An unknown-size cluster is terminated inside parse_cluster;
                # scan forward from here for further clusters.
                nxt = data.find(_CLUSTER.to_bytes(4, "big"), p2)
                payload_end = nxt if nxt > 0 else seg_e
        pos = payload_end

    if info["track_number"] is None:
        raise ValueError("no A_OPUS track found in WebM container")
    for cs, ce in cluster_spans:
        parse_cluster(cs, ce)
    return info, packets


# -- mux (test fixtures) -------------------------------------------------------

def _enc_id(eid: int) -> bytes:
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _enc_size(size: int) -> bytes:
    for n in range(1, 9):
        if size < (1 << (7 * n)) - 1:
            return (size | (1 << (7 * n))).to_bytes(n, "big")
    raise ValueError("size too large")


def _elem(eid: int, payload: bytes) -> bytes:
    return _enc_id(eid) + _enc_size(len(payload)) + payload


def _uint_payload(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


def mux_webm_opus(
    packets: Sequence[bytes],
    pre_skip: int,
    channels: int = 1,
    samples_per_packet: int = 960,
    unknown_size_segment: bool = True,
) -> bytes:
    """Build a minimal WebM/Opus file shaped like a MediaRecorder capture.

    ``unknown_size_segment=True`` reproduces the browser's streaming
    output (Segment and Cluster sizes written as the unknown-size vint),
    which is the case the demuxer must survive.
    """
    from janus_tpu_torch.audio.opus import build_opus_head

    ebml = _elem(0x1A45DFA3, b"".join([
        _elem(0x4286, _uint_payload(1)),      # EBMLVersion
        _elem(0x42F7, _uint_payload(1)),      # EBMLReadVersion
        _elem(0x42F2, _uint_payload(4)),      # EBMLMaxIDLength
        _elem(0x42F3, _uint_payload(8)),      # EBMLMaxSizeLength
        _elem(0x4282, b"webm"),               # DocType
        _elem(0x4287, _uint_payload(4)),      # DocTypeVersion
        _elem(0x4285, _uint_payload(2)),      # DocTypeReadVersion
    ]))

    info = _elem(_INFO, b"".join([
        _elem(_TIMECODE_SCALE, _uint_payload(1_000_000)),
        _elem(0x4D80, b"janus_tpu"),          # MuxingApp
        _elem(0x5741, b"janus_tpu"),          # WritingApp
    ]))

    delay_ns = round(pre_skip * 1e9 / 48_000)
    track = _elem(_TRACK_ENTRY, b"".join([
        _elem(_TRACK_NUMBER, _uint_payload(1)),
        _elem(0x73C5, _uint_payload(1)),      # TrackUID
        _elem(_TRACK_TYPE, _uint_payload(2)), # audio
        _elem(_CODEC_ID, b"A_OPUS"),
        _elem(_CODEC_DELAY, _uint_payload(delay_ns)),
        _elem(0x6264, _uint_payload(80_000_000)),  # SeekPreRoll (80 ms)
        _elem(_CODEC_PRIVATE, build_opus_head(channels, pre_skip)),
        _elem(_AUDIO, b"".join([
            _elem(_SAMPLING_FREQ, struct.pack(">f", 48_000.0)),
            _elem(_CHANNELS, _uint_payload(channels)),
        ])),
    ]))
    tracks = _elem(_TRACKS, track)

    # Clusters of ~1 s, SimpleBlocks every 20 ms.
    ms_per_packet = samples_per_packet * 1000 // 48_000
    clusters = []
    group = 1000 // max(ms_per_packet, 1)
    for ci in range(0, max(len(packets), 1), group):
        chunk = packets[ci : ci + group]
        base_ms = ci * ms_per_packet
        blocks = [_elem(_CLUSTER_TIMECODE, _uint_payload(base_ms))]
        for j, pkt in enumerate(chunk):
            rel = j * ms_per_packet
            block = b"\x81" + struct.pack(">h", rel) + b"\x80" + pkt
            blocks.append(_elem(_SIMPLE_BLOCK, block))
        payload = b"".join(blocks)
        if unknown_size_segment:
            clusters.append(_enc_id(_CLUSTER) + b"\xff" + payload)
        else:
            clusters.append(_elem(_CLUSTER, payload))

    seg_payload = info + tracks + b"".join(clusters)
    if unknown_size_segment:
        segment = _enc_id(_SEGMENT) + b"\x01\xff\xff\xff\xff\xff\xff\xff" + seg_payload
    else:
        segment = _elem(_SEGMENT, seg_payload)
    return ebml + segment
