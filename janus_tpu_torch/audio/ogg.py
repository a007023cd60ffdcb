"""Pure-Python Ogg container demux/mux (for Ogg/Opus uploads & fixtures).

Part of the first-party replacement for the reference's FFmpeg upload
decode (reference: backend/services/transcriber.py:66-91). Implements the
Ogg framing layer (RFC 3533): pages carry 255-byte "lacing" segments;
a packet is the concatenation of segments up to one of size < 255.
Demux tolerates missing CRCs; mux emits spec-correct CRCs so fixtures
are valid files for any player.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Sequence, Tuple

__all__ = ["ogg_packets", "mux_ogg_opus", "is_ogg"]

_MAGIC = b"OggS"


def is_ogg(data: bytes) -> bool:
    return data[:4] == _MAGIC


# -- CRC (poly 0x04c11db7, no reflection, init/xorout 0 — RFC 3533 A.1) ---

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if r & 0x80000000 else (r << 1) & 0xFFFFFFFF
        table.append(r)
    return table


_TABLE = _crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


# -- demux -----------------------------------------------------------------

def ogg_packets(data: bytes) -> Iterator[Tuple[int, bytes]]:
    """Yield (stream_serial, packet_bytes) in file order.

    Packets spanning page boundaries (continuation flag) are reassembled
    per stream serial. Truncated trailing pages are dropped silently —
    browser recordings can end mid-page.
    """
    pos = 0
    pending: dict = {}  # serial -> bytearray of the unfinished packet
    while True:
        idx = data.find(_MAGIC, pos)
        if idx < 0:
            return
        if idx + 27 > len(data):
            return
        header = data[idx : idx + 27]
        version, htype = header[4], header[5]
        serial = struct.unpack_from("<I", header, 14)[0]
        n_segs = header[26]
        lace_end = idx + 27 + n_segs
        if lace_end > len(data):
            return
        lacing = data[idx + 27 : lace_end]
        body_len = sum(lacing)
        if lace_end + body_len > len(data):
            return
        if version != 0:
            pos = idx + 4
            continue
        body = data[lace_end : lace_end + body_len]
        if not (htype & 0x01):  # not a continuation — drop any stale partial
            pending.pop(serial, None)
        cur = pending.pop(serial, bytearray())
        off = 0
        for lv in lacing:
            cur += body[off : off + lv]
            off += lv
            if lv < 255:  # packet boundary
                yield serial, bytes(cur)
                cur = bytearray()
        if cur:
            pending[serial] = cur
        pos = lace_end + body_len


def demux_ogg_opus(data: bytes) -> Tuple[dict, List[bytes]]:
    """Return (opus_head_fields, audio_packets) for the first Opus stream.

    Per RFC 7845: packet 1 is OpusHead, packet 2 OpusTags, the rest audio.
    """
    from janus_tpu_torch.audio.opus import parse_opus_head

    head = None
    serial_of_opus = None
    audio: List[bytes] = []
    seen = {}
    for serial, pkt in ogg_packets(data):
        k = seen.get(serial, 0)
        seen[serial] = k + 1
        if k == 0:
            if pkt[:8] == b"OpusHead" and head is None:
                head = parse_opus_head(pkt)
                serial_of_opus = serial
        elif serial == serial_of_opus and k >= 2:
            audio.append(pkt)
    if head is None:
        raise ValueError("no Opus stream found in Ogg container")
    return head, audio


# -- mux (test fixtures / outbound clips) ----------------------------------

def _page(serial: int, seq: int, granule: int, htype: int,
          packets: Sequence[bytes]) -> bytes:
    lacing = bytearray()
    body = bytearray()
    for pkt in packets:
        q, r = divmod(len(pkt), 255)
        lacing += b"\xff" * q + bytes([r])
        body += pkt
    header = bytearray(
        _MAGIC
        + bytes([0, htype])
        + struct.pack("<q", granule)
        + struct.pack("<I", serial)
        + struct.pack("<I", seq)
        + b"\x00\x00\x00\x00"  # CRC placeholder
        + bytes([len(lacing)])
    )
    page = bytes(header) + bytes(lacing) + bytes(body)
    crc = _ogg_crc(page)
    return page[:22] + struct.pack("<I", crc) + page[26:]


def mux_ogg_opus(
    packets: Sequence[bytes],
    pre_skip: int,
    channels: int = 1,
    samples_per_packet: int = 960,
    serial: int = 0x4A414E55,  # "JANU"
) -> bytes:
    """Mux raw Opus packets into a spec-valid Ogg/Opus file (RFC 7845)."""
    from janus_tpu_torch.audio.opus import build_opus_head

    head = build_opus_head(channels, pre_skip)
    vendor = b"janus_tpu"
    tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)
    out = [
        _page(serial, 0, 0, 0x02, [head]),  # BOS
        _page(serial, 1, 0, 0x00, [tags]),
    ]
    granule = 0  # cumulative decoded samples at 48 kHz (RFC 7845 §4)
    # One audio page per ~50 packets (1 s), last page flagged EOS.
    group = 50
    seq = 2
    for i in range(0, max(len(packets), 1), group):
        chunk = list(packets[i : i + group])
        granule += samples_per_packet * len(chunk)
        is_last = i + group >= len(packets)
        out.append(_page(serial, seq, granule, 0x04 if is_last else 0x00, chunk))
        seq += 1
    return b"".join(out)
