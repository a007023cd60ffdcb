"""Upload containers in the port against the JAX package: the libopus
binding, the Ogg and WebM muxers and demuxers, and ``read_audio``, fed the
same seeded clips (after ``tests/test_decode.py``, ``tests/test_audio.py``
and ``tests/test_frontend_wire.py``). Muxed files are byte-equal, demuxed
packets and decoded PCM equal; the voice-clone embedding of an Opus upload
within the 1e-4 of ``tests/test_torch_synth.py``."""

import struct

import numpy as np
import pytest

from janus_tpu.audio import decode as j_decode
from janus_tpu.audio import ogg as j_ogg
from janus_tpu.audio import opus as j_opus
from janus_tpu.audio import webm as j_webm
from janus_tpu.audio.synthetic import voiced_phrase
from janus_tpu_torch.audio import decode as t_decode
from janus_tpu_torch.audio import ogg as t_ogg
from janus_tpu_torch.audio import opus as t_opus
from janus_tpu_torch.audio import webm as t_webm
from janus_tpu_torch.audio.wav import write_wav

SR = 48_000


@pytest.fixture(scope="module")
def clip():
    """A 1.5 s voiced phrase and its Opus packets + pre-skip, from the
    port's encoder (skips without libopus, as ``tests/test_decode.py``)."""
    if not t_opus.opus_available():
        pytest.skip("libopus not present on this host")
    pcm = np.asarray(voiced_phrase(seconds=1.5, seed=3), dtype=np.float32)
    enc = t_opus.OpusEncoder()
    packets = enc.encode(pcm)
    pre = enc.lookahead
    enc.close()
    return pcm, packets, pre


def test_opus_codec_equals_jax(clip):
    pcm, packets, pre = clip
    enc = j_opus.OpusEncoder()
    assert enc.encode(pcm) == packets and enc.lookahead == pre
    enc.close()
    outs = []
    for m in (t_opus, j_opus):
        dec = m.OpusDecoder(channels=1)
        outs.append(dec.decode_stream(packets, pre_skip=pre))
        dec.close()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert len(outs[0]) == len(packets) * t_opus.OpusEncoder.FRAME_SAMPLES - pre
    for channels, skip in ((1, pre), (2, 312)):
        head = t_opus.build_opus_head(channels, skip)
        assert head == j_opus.build_opus_head(channels, skip)
        assert t_opus.parse_opus_head(head) == j_opus.parse_opus_head(head)
    for m in (t_opus, j_opus):
        with pytest.raises(ValueError):
            m.parse_opus_head(b"NotOpus!" + b"\x00" * 16)


def _mux(m, kind, packets, pre):
    if kind == "ogg":
        return m["ogg"].mux_ogg_opus(packets, pre)
    return m["webm"].mux_webm_opus(packets, pre,
                                   unknown_size_segment=kind == "webm")


PKG = {"torch": {"ogg": t_ogg, "webm": t_webm, "decode": t_decode},
       "jax": {"ogg": j_ogg, "webm": j_webm, "decode": j_decode}}


@pytest.mark.parametrize("kind", ["ogg", "webm", "webm_sized"])
def test_mux_byte_equal(clip, kind):
    _, packets, pre = clip
    assert (_mux(PKG["torch"], kind, packets, pre)
            == _mux(PKG["jax"], kind, packets, pre))


def _laced_webm(m, packets, pre):
    """A SimpleBlock with Xiph lacing (3 frames in one block), as in
    ``tests/test_decode.py``."""
    frames = packets[:3]
    lace_sizes = b""
    for f in frames[:-1]:
        q, r = divmod(len(f), 255)
        lace_sizes += b"\xff" * q + bytes([r])
    block = (b"\x81" + struct.pack(">h", 0) + bytes([0x80 | 0x02])
             + bytes([len(frames) - 1]) + lace_sizes + b"".join(frames))
    base = m.mux_webm_opus(packets[:1], pre, unknown_size_segment=True)
    cluster = m._elem(m._CLUSTER, m._elem(m._CLUSTER_TIMECODE, b"\x00")
                      + m._elem(m._SIMPLE_BLOCK, block))
    return base[:base.find(b"\x1f\x43\xb6\x75")] + cluster


def _without_codec_private(blob, pre):
    """The OpusHead CodecPrivate turned into a Void element, so that the
    demuxer must take the pre-skip from CodecDelay (``tests/test_decode.py``
    splices the same bytes)."""
    head = t_opus.build_opus_head(1, pre)
    priv = b"\x63\xa2" + bytes([0x80 | len(head)]) + head
    assert priv in blob
    return blob.replace(priv, b"\xec" + bytes([0x80 | len(head)]) + head)


def _demux_case(case, packets, pre) -> bytes:
    if case == "ogg":
        return t_ogg.mux_ogg_opus(packets, pre)
    if case == "ogg_spanning":
        return t_ogg.mux_ogg_opus([bytes(range(256)) * 3] + packets[:2], 0)
    blob = t_webm.mux_webm_opus(packets, pre,
                                unknown_size_segment=case != "webm_sized")
    if case == "webm_truncated":
        return blob[: len(blob) * 2 // 3]
    if case == "webm_codec_delay":
        return _without_codec_private(blob, pre)
    if case == "webm_laced":
        return _laced_webm(t_webm, packets, pre)
    return blob


@pytest.mark.parametrize("case", ["ogg", "ogg_spanning", "webm", "webm_sized",
                                  "webm_truncated", "webm_codec_delay",
                                  "webm_laced"])
def test_demux_equals_jax(clip, case):
    _, packets, pre = clip
    blob = _demux_case(case, packets, pre)
    if case.startswith("ogg"):
        got = t_ogg.demux_ogg_opus(blob)
        assert got == j_ogg.demux_ogg_opus(blob)
        assert list(t_ogg.ogg_packets(blob)) == list(j_ogg.ogg_packets(blob))
    else:
        got = t_webm.demux_webm_opus(blob)
        assert got == j_webm.demux_webm_opus(blob)
    info, out = got
    assert info["pre_skip"] == (0 if case == "ogg_spanning" else pre)
    if case == "webm_truncated":
        assert 0 < len(out) < len(packets) and out == packets[:len(out)]
    elif case == "webm_laced":
        assert out == packets[:3]
    elif case == "ogg_spanning":
        assert out[0] == bytes(range(256)) * 3
    elif case != "webm_codec_delay":  # the Void splice shortens the track
        # entry by a byte, so only its pre-skip is asserted (as there)
        assert out == packets


@pytest.mark.parametrize("kind", ["wav", "webm", "ogg"])
def test_read_audio_equals_jax(clip, tmp_path, kind):
    pcm, packets, pre = clip
    if kind == "wav":
        path = tmp_path / "up.wav"
        write_wav(str(path), pcm, SR)
        src = str(path)
    else:
        src = _mux(PKG["torch"], kind, packets, pre)
    got, sr = t_decode.read_audio(src)
    ref, jsr = j_decode.read_audio(src)
    assert sr == jsr == SR
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("blob", [
    b"RIFF\x00\x00\x00\x00WAVEfmt ", b"RIFF\x00\x00\x00\x00AVI ",
    b"\x1a\x45\xdf\xa3rest", b"OggS\x00rest", b"nothing", b""])
def test_sniff_format_agrees(blob):
    assert t_decode.sniff_format(blob) == j_decode.sniff_format(blob)
    assert t_webm.is_webm(blob) == j_webm.is_webm(blob)
    assert t_ogg.is_ogg(blob) == j_ogg.is_ogg(blob)


@pytest.mark.parametrize("kind", ["webm", "ogg"])
def test_missing_libopus_raises_as_jax(monkeypatch, kind):
    """Without libopus a WebM or Ogg upload raises ``RuntimeError``, as in
    the JAX package (the synthesizer's ladder then keeps no clone voice)."""
    blob = (b"\x1a\x45\xdf\xa3" if kind == "webm" else b"OggS") + b"\x00" * 60
    errors = []
    for m in (t_decode, j_decode):
        monkeypatch.setattr(m, "opus_available", lambda: False)
        with pytest.raises(RuntimeError) as err:
            m.read_audio(blob)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kind", ["webm", "ogg"])
def test_clone_embedding_from_opus_upload_matches_jax(clip, tmp_path, kind):
    """An Opus upload saved as the clone reference: both synthesizers
    enroll it, the vectors within 1e-4 (``test_clone_embedding_matches_jax``)."""
    from janus_tpu.common.config import JanusConfig as JConfig
    from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.params import params_from_jax
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    _, packets, pre = clip
    ref = tmp_path / f"reference.{kind}"
    ref.write_bytes(_mux(PKG["torch"], kind, packets, pre))
    small = {"tts.d_model": 64, "tts.layers": 1, "tts.num_heads": 4,
             "tts.n_mels": 16, "vocoder.d_model": 16, "vocoder.layers": 1}
    jsyn = JSynthesizer(JConfig().override(**small),
                        reference_audio_path=str(ref))
    tsyn = Synthesizer(JanusConfig().override(**small),
                       speaker_params=params_from_jax(jsyn.speaker_params),
                       reference_audio_path=str(ref), device="cpu")
    assert jsyn._speaker_vec is not None and tsyn._speaker_vec is not None
    np.testing.assert_allclose(tsyn._speaker_vec.numpy(),
                               np.asarray(jsyn._speaker_vec), rtol=0,
                               atol=1e-4)
