"""The port's int8 send path against the JAX package on the CPU: the
quantizers, ``linear`` over quantized weights, ``quantize_tree``, the
bridge of quantized trees, K4's plain version against the Pallas kernel
in interpret mode, the decoder and greedy decode over int8 cross K/V, and
the demo checkpoint's packets under the int8 configuration."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.common.config import ASRConfig as JASRConfig
from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.models import asr as j_asr
from janus_tpu.models.params import flatten_with_paths as j_flatten
from janus_tpu.models.params import stack_layer_params
from janus_tpu.ops import quant as jq
from janus_tpu.ops.cross_attn import cross_attention_kv as j_cross
from janus_tpu.ops.layers import linear as j_linear
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.train.demo import demo_asr_config
from janus_tpu_torch.audio.synthetic import render_text
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models import params as t_params
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.ops import quant as tq
from janus_tpu_torch.ops.attention import attend
from janus_tpu_torch.ops.cross_attn import cross_attention_kv as t_cross
from janus_tpu_torch.ops.layers import linear as t_linear
from janus_tpu_torch.runtime.codec import SemanticEncoder

_GEOM = dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2,
             num_heads=4, vocab_size=261, max_source_positions=64,
             max_target_positions=32, max_decode_tokens=8, dtype="float32")
EOT = 257
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "demo_asr.npz")
TEXTS = ("alpha bravo", "fox golf hotel", "kilo lima")
TIMESTAMP = 1_700_000_000.25


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _pair_to_port(cls, pair):
    return cls(_t(pair.q), _t(pair.scale))


def _flat_numpy(flat_pairs):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          and v.is_floating_point() else v)
            for k, v in flat_pairs}


@pytest.fixture(scope="module")
def trees():
    """The 4x-scaled random JAX tree of ``test_torch_asr.py`` and its
    bridge into the port (fp32)."""
    jcfg = JASRConfig(**_GEOM)
    jp = jax.tree.map(lambda a: np.asarray(a) * 4.0 if a.ndim > 1
                      else np.asarray(a), j_asr.init_asr(0, jcfg))
    return jcfg, ASRConfig(**_GEOM), jp, t_params.params_from_jax(jp)


# -- quantizers: bit-equal q and scale --------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn,shape", [("quantize_weight", (96, 40)),
                                      ("quantize_kv", (2, 3, 17, 64)),
                                      ("quantize_kv_t", (2, 3, 17, 64))])
def test_quantizers_bit_equal_to_jax(fn, shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x = (0.05 * np.random.default_rng(0).standard_normal(shape)
         ).astype(np.float32)
    x[..., 3] = 0.0  # an all-zero channel / position takes the 1e-8 floor
    ref = getattr(jq, fn)(jnp.asarray(x, dtype=jdt))
    out = getattr(tq, fn)(torch.from_numpy(x).to(tdt))
    assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))


# -- linear over quantized weights ------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("kind", ["QuantizedWeight", "DynQuantizedWeight"])
def test_linear_quantized_matches_jax(kind, with_bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 64))).astype(np.float32)
    b = (0.1 * rng.standard_normal((64,))).astype(np.float32)
    jw = getattr(jq, kind)(*jq.quantize_weight(jnp.asarray(w)))
    tw = _pair_to_port(getattr(tq, kind), jw)
    ref = np.asarray(j_linear(jnp.asarray(x), jw,
                              jnp.asarray(b) if with_bias else None))
    out = t_linear(torch.from_numpy(x), tw,
                   torch.from_numpy(b) if with_bias else None).numpy()
    # fp32: the dynamic path is exact up to the rescale, the weight-only
    # path differs by the order of the fp32 sums
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_linear_int8_dynamic_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 24))).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq.linear_int8_dynamic(jnp.asarray(x), jw))
    out = tq.linear_int8_dynamic(torch.from_numpy(x),
                                 _pair_to_port(tq.QuantizedWeight, jw))
    np.testing.assert_array_equal(out.numpy(), ref)


# -- trees -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["weight", "dynamic"])
def test_quantize_tree_quantizes_the_same_paths(trees, mode):
    _, _, jp, tp = trees
    ref = dict(j_flatten(jq.quantize_tree(jp, mode=mode)))
    out = t_params.flatten_with_paths(tq.quantize_tree(tp, mode=mode))
    out = _flat_numpy(out)
    assert out.keys() == ref.keys()
    quantized = {k[:-2] for k in ref if k.endswith("/w/0")}
    assert "decoder/blocks/1/cross/k/w" in quantized
    assert "decoder/token_emb" not in quantized
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)
    cls = tq.QuantizedWeight if mode == "weight" else tq.DynQuantizedWeight
    qt = tq.quantize_tree(tp, mode=mode)
    assert isinstance(qt["encoder"]["blocks"][0]["mlp"]["fc1"]["w"], cls)
    assert isinstance(qt["encoder"]["conv1"]["w"], torch.Tensor)


def test_quantize_tree_rejects_unknown_mode(trees):
    with pytest.raises(ValueError):
        tq.quantize_tree(trees[3], mode="int4")


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("mode", ["weight", "dynamic"])
def test_params_from_jax_keeps_quantized_types(trees, mode, stacked):
    _, _, jp, _ = trees
    jqt = jq.quantize_tree(jp, mode=mode)
    ref = {k: np.asarray(v) for k, v in j_flatten(jqt)}
    if stacked:
        dec = jqt["decoder"]
        jqt = {**jqt, "decoder": {**dec, "blocks": jax.tree.map(
            np.asarray, stack_layer_params(dec["blocks"]))}}
    tp = t_params.params_from_jax(jqt)
    cls = tq.QuantizedWeight if mode == "weight" else tq.DynQuantizedWeight
    w = tp["decoder"]["blocks"][1]["cross"]["q"]["w"]
    assert type(w) is cls and w.q.dtype == torch.int8
    out = _flat_numpy(t_params.flatten_with_paths(tp))
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_cast_floating_and_fuse_qkv_keep_quantized_types(trees):
    tp = tq.quantize_tree(trees[3], mode="dynamic")
    cast = t_params.cast_floating(tp, torch.bfloat16)
    w = cast["decoder"]["blocks"][0]["attn"]["q"]["w"]
    assert type(w) is tq.DynQuantizedWeight
    # the scales round to bf16, as jax.tree.map casts them in the JAX
    # package's cast_floating
    assert w.q.dtype == torch.int8 and w.scale.dtype == torch.bfloat16
    fused = t_params.prepare_decode_params(cast)["decoder"]["blocks"][0]
    qkv = fused["attn"]["qkv"]["w"]
    assert type(qkv) is tq.DynQuantizedWeight
    assert tuple(qkv.q.shape) == (64, 192) and tuple(qkv.scale.shape) == (192,)
    attn = cast["decoder"]["blocks"][0]["attn"]
    torch.testing.assert_close(
        qkv.scale, torch.cat([attn[n]["w"].scale for n in "qkv"]),
        rtol=0, atol=0)


# -- K4: the plain version against the Pallas kernel ------------------------

@pytest.mark.parametrize("tq_len", [1, 3])
def test_cross_attention_plain_matches_jax_kernel(tq_len):
    rng = np.random.default_rng(3)
    b, h, t, dh = 2, 4, 50, 64     # T not a multiple of the 128-lane pad
    q = rng.standard_normal((b, h, tq_len, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    jk, jv = jq.quantize_kv_t(jnp.asarray(k)), jq.quantize_kv_t(jnp.asarray(v))
    ref = np.asarray(j_cross(jnp.asarray(q), jk, jv, force=True))
    tk, tv = tq.quantize_kv_t(torch.from_numpy(k)), tq.quantize_kv_t(
        torch.from_numpy(v))
    assert tuple(tk.q.shape) == (b, h, dh, t)
    out = t_cross(torch.from_numpy(q), tk, tv).numpy()
    # fp32, the same arithmetic; only the order of the sums differs
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_cross_attention_dense_and_token_major_routes():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((1, 2, 1, 16), (1, 2, 9, 16), (1, 2, 9, 16)))
    tqt, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = t_cross(tqt, tk, tv)
    torch.testing.assert_close(dense, attend(tqt, tk, tv), rtol=0, atol=0)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(j_cross(*map(jnp.asarray, (q, k, v)))),
        rtol=0, atol=1e-6)
    jk, jv = jq.quantize_kv(jnp.asarray(k)), jq.quantize_kv(jnp.asarray(v))
    out = t_cross(tqt, tq.quantize_kv(tk), tq.quantize_kv(tv)).numpy()
    np.testing.assert_allclose(out, np.asarray(j_cross(jnp.asarray(q), jk,
                                                       jv)),
                               rtol=0, atol=1e-6)


# -- the decoder over int8 cross K/V ----------------------------------------

def test_decoder_logits_int8_cross_kv_match_jax(trees):
    jcfg, tcfg, jp, tp = trees
    jpj = jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 64, 80)).astype(np.float32)
    enc = np.array(j_asr.encode_audio(jpj, jcfg, jnp.asarray(mel)))
    tokens = np.array([[256, 97, 98, 32], [256, 99, 100, 101]], np.int32)

    jstate = j_asr.init_decode_state(jpj, jcfg, jnp.asarray(enc), max_len=12,
                                     cross_kv_int8=True)
    jl, jstate = j_asr._decoder_forward(jpj, jcfg, jnp.asarray(tokens),
                                        jnp.zeros((2,), jnp.int32), jstate)
    jl2, _ = j_asr.decoder_step(jpj, jcfg, jnp.asarray([7, 8], jnp.int32),
                                jstate)

    def port(int8: bool):
        tree = t_params.prepare_decode_params(tp)
        state = t_asr.init_decode_state(tree, tcfg, torch.from_numpy(enc),
                                        max_len=12, cross_kv_int8=int8)
        tl, state = t_asr._decoder_forward(
            tree, tcfg, torch.from_numpy(tokens).long(), 0, state)
        tl2, _ = t_asr.decoder_step(tree, tcfg, torch.tensor([7, 8]), state)
        return tl.numpy(), tl2.numpy()

    got = port(True)
    assert isinstance(t_asr.init_decode_state(
        tp, tcfg, torch.from_numpy(enc), max_len=4,
        cross_kv_int8=True).cross_k[0], tq.QuantKVT)
    # fp32: the JAX package dequantizes off the TPU, the port folds the
    # scales into the columns; the two differ by fp32 rounding only
    for g, want in zip(got, (jl, jl2)):
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=1e-5)
    # dense K/V miss by the int8 error, far beyond that bar
    dense = port(False)
    assert np.abs(dense[0] - np.asarray(jl)).max() > 1e-3


def test_greedy_decode_int8_matches_jax(trees):
    jcfg, tcfg, jp, _ = trees
    jqt = jq.quantize_tree(jp, mode="dynamic")
    jpj = jax.tree.map(jnp.asarray, jqt)
    mel = np.random.default_rng(6).standard_normal((3, 64, 80)).astype(
        np.float32)
    enc = np.array(j_asr.encode_audio(jpj, jcfg, jnp.asarray(mel)))
    prompt = np.full((3, 1), 256, np.int32)
    ref = np.asarray(j_asr.greedy_decode(jpj, jcfg, jnp.asarray(enc),
                                         jnp.asarray(prompt), EOT, max_new=8,
                                         cross_kv_int8=True))
    tp = t_params.prepare_decode_params(t_params.params_from_jax(jqt))
    out = t_asr.greedy_decode(tp, tcfg, torch.from_numpy(enc),
                              torch.from_numpy(prompt).long(), EOT,
                              max_new=8, cross_kv_int8=True).numpy()
    np.testing.assert_array_equal(out, ref)


# -- the demo checkpoint under the int8 configuration -----------------------

@pytest.mark.parametrize("mode", ["weight", "dynamic"])
def test_demo_int8_packets_byte_equal(mode, monkeypatch):
    over = {"asr.decode_cross_kv_int8": True}
    jcfg = dataclasses.replace(JJanusConfig(),
                               asr=demo_asr_config()).override(**over)
    tcfg = dataclasses.replace(JanusConfig(),
                               asr=ASRConfig.demo()).override(**over)
    jenc = JEncoder(jcfg, asr_params=jq.quantize_tree(j_load_npz(CKPT),
                                                      mode=mode),
                    buckets=(96_000,))
    tenc = SemanticEncoder(tcfg, asr_params=tq.quantize_tree(
        load_npz_params(CKPT), mode=mode), buckets=(96_000,), device="cpu")
    kv_types = set()

    def recording(q, k, v):
        kv_types.add(type(k))
        return t_cross(q, k, v)

    # the encoder honours asr.decode_cross_kv_int8: its decoder attends
    # over int8 K/V
    monkeypatch.setattr(t_asr, "cross_attention_kv", recording)
    heard = []
    for seed, text in enumerate(TEXTS):
        phrase = render_text(text, 48_000, seed=seed)
        jpkt = jenc.encode_packet(phrase, timestamp=TIMESTAMP)
        tpkt = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
        assert (jpkt is None) == (tpkt is None)
        if tpkt is not None:
            assert tpkt.serialize() == jpkt.serialize()
            heard.append(tpkt.text)
    assert heard, "the int8 demo recognizer produced no transcript"
    assert kv_types == {tq.QuantKVT}
