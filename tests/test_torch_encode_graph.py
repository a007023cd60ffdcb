"""The send path's captured front on the CPU: :class:`EncodeGraph` (the
wire decode, the frontend, the encoder, the cross K/V written in place
into the greedy loop's static buffers, the prefill and the first token,
then the loop) with its step run eagerly over its static buffers, against
the eager ``SemanticEncoder._encode_impl`` bit for bit and against the JAX
package's ``SemanticEncoder._encode_impl`` at the tolerances of
``tests/test_torch_codec.py``, with byte-equal packets; the per-call
uploads replaced by constants made once; the holders' keys and lifetime.
On the card the same step is captured in a CUDA graph
(``tests/test_torch_cuda.py``)."""

import dataclasses
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from janus_tpu_torch.audio.synthetic import render_text, voiced_phrase
from janus_tpu_torch.audio.ulaw import ulaw_encode
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.ops import layers, resample
from janus_tpu_torch.ops.quant import QuantKVT, quantize_tree
from janus_tpu_torch.runtime import codec
from janus_tpu_torch.runtime.codec import (EncodeGraph, SemanticEncoder,
                                           encode_front)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "demo_asr.npz")
BUCKET = 96_000
TIMESTAMP = 1_700_000_000.25
WIRES = {"int16": {}, "ulaw": {"runtime.encode_transfer_ulaw": True},
         "fp32": {"runtime.encode_transfer_int16": False}}
KV = {"dense": {}, "int8": {"asr.decode_cross_kv_int8": True}}


def _config(wire: str, kv: str) -> JanusConfig:
    return dataclasses.replace(JanusConfig(), asr=ASRConfig.demo()).override(
        **WIRES[wire], **KV[kv])


def _encoder(wire: str, kv: str, **kw) -> SemanticEncoder:
    params = load_npz_params(CKPT)
    if kv == "int8":
        params = quantize_tree(params, mode="dynamic")
    return SemanticEncoder(_config(wire, kv), asr_params=params,
                           buckets=(BUCKET,), device="cpu", **kw)


def _phrases(seed: int) -> list:
    """Three ragged phrases (one voiced tone): padded to four lanes."""
    texts = (("alpha bravo", "fox golf hotel"), ("kilo lima", "mike"))[seed]
    out = [render_text(t, 48_000, seed=seed + i) for i, t in enumerate(texts)]
    out.append(voiced_phrase(f0=150.0 + 40 * seed, seconds=1.2 - 0.3 * seed,
                             amp=0.1, seed=seed))
    return out


def _wire_batch(enc: SemanticEncoder, phrases: list):
    """The padded batch as ``encode_batch_submit`` ships it."""
    batch = np.zeros((4, BUCKET), np.float32)
    n_valid = np.zeros(4, np.int64)
    for i, p in enumerate(phrases):
        batch[i, :len(p)] = p[:BUCKET]
        n_valid[i] = min(len(p), BUCKET)
    rt = enc.cfg.runtime
    if rt.encode_transfer_ulaw:
        batch = ulaw_encode(batch)
    elif rt.encode_transfer_int16:
        batch = np.clip(np.round(batch * 32768.0), -32768,
                        32767).astype(np.int16)
    return batch, n_valid


def _eager(enc: SemanticEncoder, batch, n_valid):
    """(enc, tokens, codes, f0, rms) of the eager path."""
    audio, nv = torch.from_numpy(batch), torch.from_numpy(n_valid)
    n16 = enc.mel_frame_budget(BUCKET)
    front = encode_front(enc.params, enc.cfg, enc._compute_dtype, audio, nv,
                         n16)
    return front[0], enc._encode_impl(audio, nv, n16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Each encode here is a few thousand small ops: on a CPU shared with
    other test workers, PyTorch's thread pool spends longer in its
    barriers than in the ops, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_front_graph_equals_the_eager_encode(wire, kv):
    """Two batches in turn through one holder: the second call gives its
    own batch's encoder output, tokens, codes, f0 and rms, bit-equal to
    the eager path (nothing left over from the call before)."""
    enc = _encoder(wire, kv)
    batches = [_wire_batch(enc, _phrases(s)) for s in (0, 1)]
    with enc._graphs.lock:
        holder = enc.encode_graph(BUCKET, 4)
        assert holder.audio.dtype == torch.from_numpy(batches[0][0]).dtype
        first = holder.run(*batches[0])
        out = holder.run(*batches[1])
        assert enc.encode_graph(BUCKET, 4) is holder
    ref_enc, ref = _eager(enc, *batches[1])
    assert torch.equal(holder.enc, ref_enc)
    for got, want in zip(out, ref):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert not torch.equal(first[0], out[0])


@pytest.mark.parametrize("wire, kv", [("int16", "int8"), ("ulaw", "dense"),
                                      ("fp32", "dense")])
def test_front_graph_matches_jax_with_equal_packets(wire, kv, monkeypatch):
    import jax.numpy as jnp

    from janus_tpu.common.config import JanusConfig as JJanusConfig
    from janus_tpu.common.protocol import JanusPacket as JPacket
    from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
    from janus_tpu.ops import quant as jq
    from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
    from janus_tpu.train.demo import demo_asr_config

    jcfg = dataclasses.replace(JJanusConfig(), asr=demo_asr_config()
                               ).override(**WIRES[wire], **KV[kv])
    jp = j_load_npz(CKPT)
    if kv == "int8":
        jp = jq.quantize_tree(jp, mode="dynamic")
    jenc = JEncoder(jcfg, asr_params=jp, buckets=(BUCKET,))
    enc = _encoder(wire, kv)
    phrases = _phrases(0)
    batch, n_valid = _wire_batch(enc, phrases)
    with enc._graphs.lock:
        out = enc.encode_graph(BUCKET, 4).run(batch, n_valid)
    ref = [np.asarray(a) for a in jenc._encode_jit(
        jenc.params, jnp.asarray(batch), jnp.asarray(n_valid),
        n_16k_frames=jenc.mel_frame_budget(BUCKET))]
    tokens, e_code, p_code, f0, rms = (a.numpy() for a in out)
    np.testing.assert_array_equal(tokens, ref[0])
    np.testing.assert_array_equal(e_code, ref[1])
    np.testing.assert_array_equal(p_code, ref[2])
    np.testing.assert_allclose(f0, ref[3], rtol=0, atol=1e-2)
    np.testing.assert_allclose(rms, ref[4], rtol=0, atol=1e-6)
    # encode_batch through the graph path (its step eager on the CPU), the
    # JAX one through the program compiled above: byte-equal packets
    monkeypatch.setattr(codec, "use_graphs", lambda device, eager=False:
                        not eager)
    assert enc._graphed()
    got, want = enc.encode_batch(phrases), jenc.encode_batch(phrases)
    assert enc._graphs.holders("encode")[0].graph.replays == 2
    for a, b in zip(got, want):
        assert a["text"] and a["text"] == b["text"]
        assert JanusPacket(text=a["text"], prosody=a["prosody"],
                           timestamp=TIMESTAMP).serialize() == JPacket(
            text=b["text"], prosody=b["prosody"],
            timestamp=TIMESTAMP).serialize()


def test_encode_batch_takes_the_path_use_graphs_names(monkeypatch):
    """The CPU encodes eagerly (no holder); with the graph path named, the
    same results come through a holder per (bucket, padded batch); the
    eager flag keeps the eager path."""
    enc = _encoder("int16", "dense")
    phrases = _phrases(0)
    ref = enc.encode_batch(phrases)
    assert not enc._graphed() and not enc._graphs.holders()
    monkeypatch.setattr(codec, "use_graphs", lambda device, eager=False:
                        not eager)
    assert enc.encode_batch(phrases) == ref
    assert enc.encode_batch(phrases[:1]) == ref[:1]
    fronts = enc._graphs.holders("encode")
    assert [h.audio.shape[0] for h in fronts] == [4, 1]
    assert len(enc._graphs.holders("greedy")) == 2
    eager = _encoder("int16", "dense", eager=True)
    assert not eager._graphed()
    assert eager.encode_batch(phrases) == ref
    assert not eager._graphs.holders()


def test_cross_kv_are_written_in_place():
    """The front writes each layer's cross K/V into the loop's static
    buffers (their storage never changes) with the values a fresh
    projection gives; the int8 K/V's padding past T stays zero."""
    for kv in sorted(KV):
        enc = _encoder("int16", kv)
        with enc._graphs.lock:
            holder = enc.encode_graph(BUCKET, 4)
            st = holder.greedy.state
            cross = st.cross_k + st.cross_v
            leaves = [t for c in cross
                      for t in ((c.q, c.scale) if isinstance(c, QuantKVT)
                                else (c,))]
            ptrs = [t.data_ptr() for t in leaves]
            for s in (0, 1):
                holder.run(*_wire_batch(enc, _phrases(s)))
                ks, vs = t_asr._cross_kv(enc.params, enc.cfg.asr, holder.enc,
                                         kv == "int8")
                for dst, src in zip(cross, ks + vs):
                    if isinstance(dst, QuantKVT):
                        assert torch.equal(dst.q, src.q)
                        assert torch.equal(dst.scale, src.scale)
                        base = dst.q.as_strided(
                            dst.q.shape[:-1] + (dst.q.stride(-2),),
                            dst.q.stride())
                        assert not base[..., dst.q.shape[-1]:].any()
                    else:
                        assert torch.equal(dst, src)
            assert [t.data_ptr() for t in leaves] == ptrs
            assert all(a is b for a, b in zip(st.cross_k + st.cross_v,
                                               cross))


def test_cached_constants_equal_the_per_call_ones():
    """The sinusoid table, the decimator's tap matrix and the prompt are
    made once per (shape, device) with the values the per-call uploads
    had, bit for bit."""
    cpu = torch.device("cpu")
    pos = layers.sinusoid_positions(100, 128, device=cpu)
    assert layers.sinusoid_positions(100, 128, device="cpu") is pos
    log_inc = np.log(10_000.0) / (64 - 1)
    scaled = np.arange(100)[:, None] * np.exp(-log_inc * np.arange(64))[None]
    want = np.concatenate([np.sin(scaled), np.cos(scaled)], 1)
    assert torch.equal(pos, torch.from_numpy(want.astype(np.float32)))
    assert layers.sinusoid_positions(101, 128).shape == (101, 128)
    w = resample._decimate_matmul_table(3, 96, 256, cpu)
    assert resample._decimate_matmul_table(3, 96, 256, cpu) is w
    assert torch.equal(w, torch.from_numpy(
        resample._decimate_matmul_weights(3, 96, 256)[0]))
    enc = _encoder("int16", "dense")
    prompt = enc._prompt(cpu)
    assert enc._prompt(cpu) is prompt
    assert torch.equal(prompt, torch.tensor(enc.tokenizer.sot_sequence(),
                                            dtype=torch.long))


def test_distinct_keys_give_distinct_holders():
    """A holder per (bucket, padded batch, wire dtype), each with the
    greedy holder of its shape; a repeated key gives the same holder."""
    enc = SemanticEncoder(_config("int16", "dense"), asr_params=
                          load_npz_params(CKPT), buckets=(48_000, BUCKET),
                          device="cpu")
    with enc._graphs.lock:
        keys = [(BUCKET, 4), (BUCKET, 2), (48_000, 4)]
        holders = [enc.encode_graph(*k) for k in keys]
        assert len({id(h) for h in holders}) == len(keys)
        assert enc.encode_graph(BUCKET, 4) is holders[0]
        assert [tuple(h.audio.shape) for h in holders] == [
            (4, BUCKET), (2, BUCKET), (4, 48_000)]
        assert len(enc._graphs.holders("greedy")) == 3
        assert holders[2].greedy.state.cross_k[0].shape[-2] == 100 // 2
    # the wire dtype is the configuration's: one encoder's fronts share it,
    # and the key holds it
    for wire, dtype in (("int16", torch.int16), ("ulaw", torch.uint8),
                        ("fp32", torch.float32)):
        enc = _encoder(wire, "dense")
        with enc._graphs.lock:
            h = enc.encode_graph(BUCKET, 4)
        (key,) = [k for k in enc._graphs._holders if k[0] == "encode"]
        assert h.audio.dtype == h.host_audio.dtype == dtype
        assert key[:4] == ("encode", BUCKET, 4, dtype)


def test_a_front_holder_and_its_graph_form_no_cycle():
    """The holder keeps what it needs of its encoder, not the encoder, and
    its ``StepGraph`` holds the step weakly: dropping the encoder frees its
    holders at once, without the cyclic collector."""
    enc = _encoder("int16", "dense")
    with enc._graphs.lock:
        holder = enc.encode_graph(BUCKET, 4)
    assert isinstance(holder, EncodeGraph)
    gone = [weakref.ref(o) for o in (enc, holder, holder.greedy)]
    del holder
    collecting = gc.isenabled()
    gc.disable()
    try:
        del enc
        assert all(r() is None for r in gone)
    finally:
        if collecting:
            gc.enable()


def test_yin_scans_one_row_as_it_scans_many():
    """YIN's prefix sums take the row-wise scan for a single row too (on
    the card a one-row cumsum is CUB's single-pass scan, whose float sums
    follow the blocks' timing): the same bits as ``torch.cumsum``, and a
    row's sums do not depend on the rows beside it."""
    from janus_tpu_torch.ops.yin import _cumsum

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4001)).astype(np.float32))
    for t in (x, x[:1], x[0], x[:, None, :]):
        assert torch.equal(_cumsum(t), torch.cumsum(t, dim=-1))
    assert torch.equal(_cumsum(x[:1])[0], _cumsum(x)[0])

