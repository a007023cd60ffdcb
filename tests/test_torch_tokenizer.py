"""The port's ``BpeTokenizer`` against the JAX package's on the CPU, and
the drop-in path it opens: a Whisper-style four-token ``sot_sequence``
through ``SemanticEncoder`` in both packages (byte-equal packets) and
through the greedy loop's captured-step path (``GreedyGraph`` at
``prompt_len`` 4) against the eager loop and the JAX package.

The vocabulary pair is written under ``tmp_path``: the 256 GPT-2 byte
symbols, merges that build a few words left to right plus seeded random
ones, and the specials."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.common.config import ASRConfig as JASRConfig
from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.models import asr as j_asr
from janus_tpu.models.tokenizer import BpeTokenizer as JBpeTokenizer
from janus_tpu.ops import quant as jq
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu_torch.audio.synthetic import voiced_phrase
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models import tokenizer as t_tok
from janus_tpu_torch.models.params import (params_from_jax,
                                           prepare_decode_params)
from janus_tpu_torch.models.tokenizer import BpeTokenizer
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.step_graph import StepGraphs

SPECIALS = ("<|endoftext|>", "<|startoftranscript|>", "<|en|>",
            "<|transcribe|>", "<|notimestamps|>")
WORDS = ("hello", " world", " the", " codec", "ing", " é", "ü", " hello")
TEXTS = ("hello world", "the codec", " leading space", "two  spaces  here",
         "codecing hello", "é ü ñ 日本語 🙂", "xyzzy", "")
TIMESTAMP = 1_700_000_000.25
BUCKETS = (96_000,)
# one compile per config, cache dtype and weight layout (eager, each
# call of the JAX decode loop traces and compiles it anew: ~4 s)
J_ENCODE = jax.jit(j_asr.encode_audio, static_argnames=("cfg",))
J_GREEDY = jax.jit(j_asr.greedy_decode, static_argnames=(
    "cfg", "eot_id", "max_new", "cache_dtype", "cross_kv_int8"))


def _merges(seed: int = 0, n_random: int = 16):
    """Merges that build ``WORDS`` left to right, one ``x y`` merge whose
    result the vocab lacks (an unknown merged piece), then seeded random
    merges of letter symbols."""
    b2u = t_tok._bytes_to_unicode()
    merges, made = [], set()
    for word in WORDS:
        sym = [b2u[b] for b in word.encode("utf-8")]
        cur = sym[0]
        for s in sym[1:]:
            if cur + s not in made:
                merges.append((cur, s))
                made.add(cur + s)
            cur += s
    merges.append(("x", "y"))
    rng = np.random.default_rng(seed)
    letters = [b2u[b] for b in range(ord("a"), ord("z") + 1)]
    target = len(merges) + n_random
    while len(merges) < target:
        a, b = (letters[i] for i in rng.integers(0, 26, size=2))
        if a + b not in made:
            merges.append((a, b))
            made.add(a + b)
    return merges, made


def _write_pair(path, specials=SPECIALS, drop=()):
    """``vocab.json`` + ``merges.txt`` (with a version comment and a blank
    line) under ``path``; ``drop`` leaves byte symbols out of the vocab.
    Returns the two paths and the vocab."""
    b2u = t_tok._bytes_to_unicode()
    merges, made = _merges()
    vocab = {}
    for sym in list(b2u.values()) + [a + b for a, b in merges
                                     if (a, b) != ("x", "y")]:
        if sym not in drop and sym not in vocab:
            vocab[sym] = len(vocab)
    for s in specials:
        vocab[s] = len(vocab)
    path.mkdir(parents=True, exist_ok=True)
    vp, mp = path / "vocab.json", path / "merges.txt"
    vp.write_text(json.dumps(vocab))
    mp.write_text("#version: 0.2\n\n" + "\n".join(f"{a} {b}" for a, b in
                                                 merges) + "\n\n")
    return str(vp), str(mp), vocab


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _write_pair(tmp_path_factory.mktemp("bpe"))


@pytest.fixture(scope="module")
def toks(pair):
    vp, mp, _ = pair
    return BpeTokenizer.from_files(vp, mp), JBpeTokenizer.from_files(vp, mp)


# -- the tokenizer -----------------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_decode_match_jax(toks, text):
    tok, jtok = toks
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids) == text


def test_merges_apply_and_unknowns_fall_back(toks, pair):
    """Merged words are one id each; ``xy`` (merged, not in the vocab)
    falls back to its characters' ids."""
    tok, _ = toks
    vocab = pair[2]
    assert tok.encode("hello world") == [vocab["hello"], vocab["Ġworld"]]
    assert tok.encode(" é") == [vocab["ĠÃ©"]]
    assert tok._bpe("xy") == ("xy",)
    assert tok.encode("xy") == [vocab["x"], vocab["y"]]
    # the rank order decides: "he" outranks "Ġh", so " hello" never
    # reaches the chain that starts with "Ġh"
    assert tok.encode(" hello") == [vocab["Ġ"], vocab["hello"]]


def test_unknown_character_is_id_0_as_jax(tmp_path):
    vp, mp, vocab = _write_pair(tmp_path, drop=("z", "Ġ"))
    tok, jtok = BpeTokenizer.from_files(vp, mp), JBpeTokenizer.from_files(
        vp, mp)
    for text in ("zap", "a z", "hello world"):
        assert tok.encode(text) == jtok.encode(text)
    assert tok.encode("z") == [0] and vocab["!"] == 0


def test_decode_drops_ids_outside_the_vocab(toks):
    tok, jtok = toks
    ids = [-5, tok.encode("hi")[0], 10 ** 6, tok.vocab_size,
           *tok.encode("!")]
    assert tok.decode(ids) == jtok.decode(ids) == "h!"
    # a special decodes to its own characters, as in the JAX package
    assert tok.decode([tok.eot]) == jtok.decode([jtok.eot]) == "<|endoftext|>"
    # a lone continuation byte is replaced, as in the JAX package
    cont = tok.encode("é")[-1:]
    assert tok.decode(cont) == jtok.decode(cont)


@pytest.mark.parametrize("specials", [
    SPECIALS, SPECIALS[:2] + SPECIALS[3:4], SPECIALS[:1], SPECIALS[1:2], ()],
    ids=["all", "some", "eot-only", "sot-only", "none"])
def test_specials_and_defaults_match_jax(tmp_path, specials):
    vp, mp, vocab = _write_pair(tmp_path, specials=specials)
    tok, jtok = BpeTokenizer.from_files(vp, mp), JBpeTokenizer.from_files(
        vp, mp)
    for name in ("vocab_size", "sot", "eot", "pad"):
        assert getattr(tok, name) == getattr(jtok, name), name
    assert tok.sot_sequence() == jtok.sot_sequence()
    assert tok.vocab_size == max(vocab.values()) + 1
    assert tok.eot == vocab.get("<|endoftext|>", tok.vocab_size - 1)
    assert tok.sot == vocab.get("<|startoftranscript|>", tok.eot)
    assert tok.pad == tok.eot
    assert len(tok.sot_sequence()) == 1 + sum(
        s in specials for s in SPECIALS[2:])


def test_from_files_skips_comments_and_blank_lines(pair, toks):
    vp, mp, vocab = pair
    tok, _ = toks
    merges, _ = _merges()
    assert tok.bpe_ranks == {m: i for i, m in enumerate(merges)}
    assert tok.encoder == vocab
    assert tok.sot_sequence() == [vocab[s] for s in SPECIALS[1:]]


# -- the drop-in path: four-token prompts -----------------------------------

def _geom(vocab_size):
    return dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2,
                num_heads=4, vocab_size=vocab_size, max_source_positions=64,
                max_target_positions=32, max_decode_tokens=8,
                dtype="float32")


@pytest.fixture(scope="module")
def asr_trees(toks):
    """A seeded tiny recognizer with its vocab sized to the pair; the
    weights are scaled 4x, as ``tests/test_torch_decode_graphs.py`` does,
    so that the logits separate and argmax is stable across packages."""
    geom = _geom(toks[0].vocab_size)
    jcfg = JASRConfig(**geom)
    jp = jax.tree.map(lambda a: np.asarray(a) * 4.0 if a.ndim > 1
                      else np.asarray(a), j_asr.init_asr(0, jcfg))
    mel = np.random.default_rng(2).standard_normal((3, 64, 80)).astype(
        np.float32)
    enc = np.array(J_ENCODE(jax.tree.map(jnp.asarray, jp), cfg=jcfg,
                            mel=jnp.asarray(mel)))
    return jcfg, ASRConfig(**geom), jp, enc


def test_semantic_encoder_with_bpe_gives_jax_packets(toks, asr_trees):
    """``SemanticEncoder(tokenizer=bpe)`` in both packages, the prompt its
    ``sot_sequence`` of four ids: byte-equal packets from
    ``encode_packet`` and equal results from ``encode_batch``."""
    tok, jtok = toks
    jcfg, tcfg, jp, _ = asr_trees
    jenc = JEncoder(dataclasses.replace(JJanusConfig(), asr=jcfg),
                    asr_params=jp, tokenizer=jtok, buckets=BUCKETS)
    tenc = SemanticEncoder(dataclasses.replace(JanusConfig(), asr=tcfg),
                           asr_params=params_from_jax(jp), tokenizer=tok,
                           buckets=BUCKETS, device="cpu")
    assert len(tok.sot_sequence()) == 4
    phrases = [voiced_phrase(f0=120.0 + 40 * i, seconds=1.0 + 0.25 * i,
                             amp=0.1, seed=i) for i in range(3)]
    texts = []
    for phrase in phrases:
        jpkt = jenc.encode_packet(phrase, timestamp=TIMESTAMP)
        tpkt = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
        assert (jpkt is None) == (tpkt is None)
        if tpkt is not None:
            assert tpkt.serialize() == jpkt.serialize()
            texts.append(tpkt.text)
    assert texts, "the random recognizer gave no transcript"
    ref = jenc.encode_batch(phrases)
    out = tenc.encode_batch(phrases)
    for a, b in zip(out, ref):
        assert a["text"] == b["text"] and a["prosody"] == b["prosody"]


CACHE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_greedy_step_path_with_a_four_token_prompt(toks, asr_trees, int8,
                                                   cache_dtype):
    """``GreedyGraph`` at ``prompt_len`` 4 (the column it writes is
    ``pos - 3``, its caches ``4 + max_new`` long) gives the eager loop's
    tokens bit for bit, call after call on one holder, and the JAX
    package's tokens; the prefill runs four query rows through the
    cross-attention (int8 K/V: the K4 kernel's plain version)."""
    tok, _ = toks
    jcfg, tcfg, jp, enc = asr_trees
    jtree = jq.quantize_tree(jp, mode="dynamic") if int8 else jp
    tp = prepare_decode_params(params_from_jax(jtree))
    jdt, tdt = CACHE_DTYPES[cache_dtype]
    prompt = np.broadcast_to(np.asarray(tok.sot_sequence(), np.int32),
                             (3, 4))
    # the encoder's prompt: one row expanded over the lanes (not contiguous)
    p = torch.tensor(tok.sot_sequence()).expand(3, 4)
    graphs = StepGraphs()
    for scale in (1.0, 0.5):
        e = torch.from_numpy((enc * scale).astype(np.float32))
        eager = t_asr.greedy_decode(tp, tcfg, e, p, tok.eot, max_new=8,
                                    cache_dtype=tdt, cross_kv_int8=int8,
                                    eager=True)
        stepped = t_asr._greedy_graphed(tp, tcfg, e, p, tok.eot, 8, tdt,
                                        int8, graphs)
        assert stepped.shape == (3, 8) and torch.equal(stepped, eager)
        ref = np.asarray(J_GREEDY(
            jax.tree.map(jnp.asarray, jtree), cfg=jcfg,
            enc=jnp.asarray(e.numpy()), prompt=jnp.asarray(prompt),
            eot_id=tok.eot, max_new=8, cache_dtype=jdt, cross_kv_int8=int8))
        np.testing.assert_array_equal(stepped.numpy(), ref)
    (holder,) = graphs._holders.values()
    assert holder.prompt_len == 4 and holder.cache_len == 12
    # each call one run of the holder's loop graph, of 7 steps
    assert graphs.replays == 2 and graphs.steps == 14
