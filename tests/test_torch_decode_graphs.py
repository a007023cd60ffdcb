"""The decode loops' captured-step path on the CPU: the static buffers of
``GreedyGraph`` (the recognizer's greedy search) and ``ARGraph`` (the TTS
AR loop) with the device-position step run eagerly over them, against the
eager loops bit for bit and against the JAX package at the tolerances of
``tests/test_torch_asr.py`` and ``tests/test_torch_tts.py``; the loops'
exits decided from the ``done`` flags before every step, as the card's
conditional nodes decide them; the holders' overflow checks; the kernel
accounting of replays; the choice of path; two decoder layers and two TTS
blocks with the residual adds and the cache writes taken into the norms'
and the attention's calls, bit-equal to the add and norm, write and
attention apart. On the card the same step is captured in a CUDA graph
(``tests/test_torch_cuda.py``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.common.config import ASRConfig as JASRConfig
from janus_tpu.common.config import TTSConfig as JTTSConfig
from janus_tpu.models import asr as j_asr
from janus_tpu.models import tts as j_tts
from janus_tpu.ops import quant as jq
from janus_tpu_torch.common.config import ASRConfig, TTSConfig
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models import tts as t_tts
from janus_tpu_torch.models.params import (params_from_jax,
                                           prepare_decode_params)
from janus_tpu_torch.ops.attention import KVCache, fill_mask
from janus_tpu_torch.ops.cuda_build import KERNELS
from janus_tpu_torch.runtime import step_graph
from janus_tpu_torch.runtime.step_graph import (StepGraph, StepGraphs,
                                                use_graphs)

_GEOM = dict(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2,
             num_heads=4, vocab_size=261, max_source_positions=64,
             max_target_positions=32, max_decode_tokens=8, dtype="float32")
EOT = 257
TTS_KW = dict(d_model=64, layers=2, num_heads=4, n_mels=16, reduction=2,
              max_text_tokens=32, max_mel_frames=32)
CACHE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def asr_trees():
    """The 4x-scaled random JAX tree of ``test_torch_asr.py`` (the logits
    separate, so argmax is stable) and an encoder output of it."""
    jcfg = JASRConfig(**_GEOM)
    jp = jax.tree.map(lambda a: np.asarray(a) * 4.0 if a.ndim > 1
                      else np.asarray(a), j_asr.init_asr(0, jcfg))
    mel = np.random.default_rng(2).standard_normal((3, 64, 80)).astype(
        np.float32)
    enc = np.array(j_asr.encode_audio(jax.tree.map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(mel)))
    return jcfg, ASRConfig(**_GEOM), jp, enc


@pytest.fixture(scope="module")
def tts_tree():
    return j_tts.init_tts(0, JTTSConfig(**TTS_KW), text_vocab=261)


def _port_asr(jp, int8: bool):
    if int8:
        jp = jq.quantize_tree(jp, mode="dynamic")
    return prepare_decode_params(params_from_jax(jp)), jp


def _prompt(batch, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, size=(batch, 8)).astype(np.int32)
    emo = rng.integers(0, len(t_tts.EMOTIONS), size=(batch,)).astype(
        np.int32)
    spk = rng.standard_normal((batch, TTS_KW["d_model"])).astype(np.float32)
    return text, emo, spk


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the recognizer's greedy loop ---------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_greedy_step_path_equals_eager_loop(asr_trees, int8, cache_dtype):
    """The device-position step over the holder's static buffers gives
    the eager loop's tokens bit for bit, call after call on one holder
    (the fill zeroes the caches and copies the new cross K/V in), dense
    and int8 cross K/V, fp32 and bf16 caches; with fp32 caches both equal
    the JAX package's tokens, as ``test_torch_asr.py`` holds them."""
    jcfg, tcfg, jp, enc = asr_trees
    tp, jtree = _port_asr(jp, int8)
    jdt, tdt = CACHE_DTYPES[cache_dtype]
    prompt = np.full((3, 1), 256, np.int32)
    graphs = StepGraphs()
    for scale in (1.0, 0.5):
        e = (enc * scale).astype(np.float32)
        eager = t_asr.greedy_decode(tp, tcfg, _t(e), _t(prompt).long(), EOT,
                                    max_new=8, cache_dtype=tdt,
                                    cross_kv_int8=int8)
        stepped = t_asr._greedy_graphed(tp, tcfg, _t(e), _t(prompt).long(),
                                        EOT, 8, tdt, int8, graphs)
        assert stepped.dtype == torch.int32 and stepped.shape == (3, 8)
        assert torch.equal(stepped, eager)
        if cache_dtype == "float32":
            ref = np.asarray(j_asr.greedy_decode(
                jax.tree.map(jnp.asarray, jtree), jcfg, jnp.asarray(e),
                jnp.asarray(prompt), EOT, max_new=8, cache_dtype=jdt,
                cross_kv_int8=int8))
            np.testing.assert_array_equal(stepped.numpy(), ref)
    # one holder; each call one run of its loop graph, of 7 steps
    assert len(graphs.graphs()) == len(graphs.loops()) == 1
    assert graphs.replays == 2 and graphs.steps == 14


def _asr_eot_at(jp, step):
    """A tree whose decoder emits eot at ``step`` (the prompt is one
    token): the position row that step feeds is pushed far along the eot
    embedding, so the tied head's argmax there is eot in every lane."""
    if step is None:
        return jp
    dec = dict(jp["decoder"])
    pos = np.array(dec["pos_emb"])
    e = np.asarray(dec["token_emb"])[EOT]
    pos[step] += 200.0 * e / np.linalg.norm(e)
    dec["pos_emb"] = pos
    return {**jp, "decoder": dec}


@pytest.mark.parametrize("stop", [1, 7, 8, 9, None],
                         ids=["1", "7", "8", "9", "never"])
def test_greedy_device_exit_matches_jax(asr_trees, stop):
    """Lanes that emit eot at step 1, 7, 8 or 9 (around the reads the
    host loop made at steps 1, 9, 17 before the exit moved to the card)
    or never: the loop graph's tokens equal the eager loop's and the JAX
    package's, and it ran the JAX ``while_loop``'s trips."""
    jcfg, tcfg, jp, enc = asr_trees
    jp = _asr_eot_at(jp, stop)
    tp = prepare_decode_params(params_from_jax(jp))
    prompt = np.full((3, 1), 256, np.int32)
    ref = np.asarray(j_asr.greedy_decode(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(enc),
        jnp.asarray(prompt), EOT, max_new=16))
    eager = t_asr.greedy_decode(tp, tcfg, _t(enc), _t(prompt).long(), EOT,
                                max_new=16)
    graphs = StepGraphs()
    stepped = t_asr._greedy_graphed(tp, tcfg, _t(enc), _t(prompt).long(),
                                    EOT, 16, torch.float32, False, graphs)
    assert torch.equal(stepped, eager)
    np.testing.assert_array_equal(stepped.numpy(), ref)
    if stop is not None:
        assert (ref[:, stop:] == EOT).all() and (ref[:, :stop] != EOT).all()
    else:
        assert (ref != EOT).all()
    (loop,) = graphs.loops()
    assert graphs.steps == loop.trips_run == (15 if stop is None else stop)


def test_greedy_host_raises_before_an_overflow(asr_trees):
    """A loop that would read past the position table (32 rows) raises at
    the holder's construction, before any capture; a single step past the
    caches' capacity raises on the host before its replay, and a step
    after a loop run (whose fill point only the device knows) is refused
    until the next prime."""
    _, tcfg, jp, enc = asr_trees
    tp = prepare_decode_params(params_from_jax(jp))
    prompt = torch.full((3, 1), 256)
    graphs = StepGraphs()
    with pytest.raises(ValueError, match="position 39 lies outside"):
        t_asr._greedy_graphed(tp, tcfg, _t(enc), prompt, EOT, 40,
                              torch.float32, False, graphs)
    assert not graphs.holders()
    with graphs.lock:
        h = t_asr.greedy_graph(graphs, tp, tcfg, 3, enc.shape[1],
                               torch.float32, 1, 8, torch.float32, False,
                               EOT, torch.device("cpu"))
    h.decode(_t(enc), prompt)
    with pytest.raises(RuntimeError, match="prime before stepping"):
        h.advance()
    h.prime(_t(enc), prompt)
    for _ in range(8):
        h.advance()   # to the last slot of the caches
    out = h.out.clone()
    with pytest.raises(ValueError, match="KV cache overflow"):
        h.advance()
    assert torch.equal(h.out, out)


# -- the TTS AR loop ----------------------------------------------------------

@pytest.mark.parametrize("stop_threshold", [2.0, 0.5])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_tts_step_path_equals_eager_loop(tts_tree, cache_dtype,
                                         stop_threshold):
    """fp32 parameters: the stepped ``tts_generate`` equals the eager
    one bit for bit (mel and ``n_frames``), and the JAX package within
    ``test_torch_tts.py``'s bars (fp32 caches 1e-4, bf16 caches 2e-4)
    with ``n_frames`` equal."""
    jc = JTTSConfig(**TTS_KW, dtype=cache_dtype)
    tc = TTSConfig(**TTS_KW, dtype=cache_dtype)
    tp = params_from_jax(tts_tree)
    text, emo, spk = _prompt(3, seed=3)
    graphs = StepGraphs()
    eager = t_tts.tts_generate(tp, tc, _t(text), _t(emo), speaker=_t(spk),
                               stop_threshold=stop_threshold)
    stepped = t_tts._generate_graphed(tp, tc, _t(text), _t(emo), _t(spk), 16,
                                      261, stop_threshold, graphs)
    assert torch.equal(stepped[0], eager[0])
    assert torch.equal(stepped[1], eager[1])
    ref_mel, ref_n = j_tts.tts_generate(
        tts_tree, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), stop_threshold=stop_threshold)
    np.testing.assert_array_equal(stepped[1].numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(
        stepped[0].numpy(), np.asarray(ref_mel), rtol=0,
        atol=1e-4 if cache_dtype == "float32" else 2e-4)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_tts_chunks_through_the_step_path_equal_eager(tts_tree, cache_dtype):
    """``tts_prefill`` + ``tts_decode_chunk`` in chunks of 7 over the
    holder's static caches give the eager chunks bit for bit, including
    a last chunk that runs to the caches' end (15 steps of a 16-group
    budget would stop at 15; the holder takes the 16th, as eager does)."""
    tc = TTSConfig(**TTS_KW, dtype=cache_dtype)
    tp = params_from_jax(tts_tree)
    text, emo, spk = _prompt(2, seed=5)
    args = (tp, tc, _t(text), _t(emo), _t(spk), 16, 261, 0.5)
    first, done, state = t_tts._prefill_graphed(*args, StepGraphs())
    f0, d0, s0 = t_tts.tts_prefill(tp, tc, _t(text), _t(emo),
                                   speaker=_t(spk), max_groups=16)
    assert torch.equal(first, f0) and torch.equal(done, d0)
    assert state.graph is not None and s0.graph is None
    a, b = (first, done), (f0, d0)
    for lo, n in ((0, 7), (7, 7), (14, 2)):
        got = t_tts.tts_decode_chunk(tp, tc, state, *a, lo, n)
        want = t_tts.tts_decode_chunk(tp, tc, s0, *b, lo, n)
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        a, b = got[2:4], want[2:4]


def _tts_stop_at(jp, step):
    """A tree whose stop head fires at AR step ``step`` in every lane (at
    none for None): it reads one channel of the final norm (bias -6), and
    the position row that step feeds is pushed far along that channel."""
    d = TTS_KW["d_model"]
    pos = np.array(jp["pos_emb"])
    if step is not None:
        pos[t_tts.audio_pos_base(TTSConfig(**TTS_KW)) + step - 1, 5] += 200.0
    w = np.zeros((d, 1), np.float32)
    w[5, 0] = 1.0
    return {**jp, "pos_emb": pos,
            "stop_head": {"w": w, "b": np.full((1,), -6.0, np.float32)}}


@pytest.mark.parametrize("stop", [1, 7, 8, 9, None],
                         ids=["1", "7", "8", "9", "never"])
def test_tts_device_exit_matches_jax(tts_tree, stop):
    """Lanes that stop at AR step 1, 7, 8 or 9 or never: the loop graph's
    mel and ``n_frames`` equal the eager loop's bit for bit, and the JAX
    package's (``n_frames`` equal, mel within 1e-4), and it ran the JAX
    ``while_loop``'s trips."""
    jp = _tts_stop_at(tts_tree, stop)
    jc, tc = JTTSConfig(**TTS_KW, dtype="float32"), TTSConfig(
        **TTS_KW, dtype="float32")
    tp = params_from_jax(jp)
    text, emo, spk = _prompt(3, seed=7)
    eager = t_tts.tts_generate(tp, tc, _t(text), _t(emo), speaker=_t(spk))
    graphs = StepGraphs()
    stepped = t_tts._generate_graphed(tp, tc, _t(text), _t(emo), _t(spk), 16,
                                      261, 0.5, graphs)
    assert torch.equal(stepped[0], eager[0])
    assert torch.equal(stepped[1], eager[1])
    ref_mel, ref_n = j_tts.tts_generate(
        jp, jc, jnp.asarray(text), jnp.asarray(emo), speaker=jnp.asarray(spk))
    np.testing.assert_array_equal(stepped[1].numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(stepped[0].numpy(), np.asarray(ref_mel),
                               rtol=0, atol=1e-4)
    groups = 16 if stop is None else stop + 1
    assert stepped[1].tolist() == [groups * 2] * 3
    (loop,) = graphs.loops()
    assert graphs.steps == loop.trips_run == groups - 1


def test_tts_host_raises_before_an_overflow(tts_tree):
    """A chunk past the caches' capacity raises before its replay, as the
    eager chunk raises; a budget whose loop would read past a (truncated)
    position table raises at the holder's construction, before any
    capture; a state refilled by a later prefill is refused."""
    tc = TTSConfig(**TTS_KW, dtype="float32")
    tp = params_from_jax(tts_tree)
    text, emo, spk = _prompt(2, seed=9)
    graphs = StepGraphs()
    args = (tp, tc, _t(text), _t(emo), _t(spk), 16, 261, 0.5)
    first, done, state = t_tts._prefill_graphed(*args, graphs)
    with pytest.raises(ValueError, match="KV cache overflow"):
        t_tts.tts_decode_chunk(tp, tc, state, first, done, 0, 17)
    assert state.graph.steps == 16
    f0, d0, s0 = t_tts.tts_prefill(tp, tc, _t(text), _t(emo),
                                   speaker=_t(spk), max_groups=16)
    with pytest.raises(ValueError, match="KV cache overflow"):
        t_tts.tts_decode_chunk(tp, tc, s0, f0, d0, 0, 17)

    base = t_tts.audio_pos_base(tc)
    short = {**tp, "pos_emb": tp["pos_emb"][:base + 4]}
    with pytest.raises(ValueError, match=f"position {base + 14} lies "
                       f"outside the position table"):
        t_tts._prefill_graphed(short, *args[1:], graphs)
    assert not graphs.holders()

    first, done, state = t_tts._prefill_graphed(*args, graphs)
    t_tts._prefill_graphed(*args, graphs)
    with pytest.raises(RuntimeError, match="refilled"):
        t_tts.tts_decode_chunk(tp, tc, state, first, done, 0, 1)


# -- the fused calls against the unfused pairs -----------------------------

def _unfuse(monkeypatch, *modules):
    """Each fused call of the models' layers as the pair it replaces: the
    residual add, then ``layer_norm``; the cache write (``write_at`` at a
    device position, ``append_lockstep`` at the fill count), then
    ``decode_attention``."""
    from janus_tpu_torch.ops.decode_attention import decode_attention
    from janus_tpu_torch.ops.layers import layer_norm

    def add_layer_norm(x, delta, scale, bias, eps=1e-5):
        r = x + delta
        return r, layer_norm(r, scale, bias, eps)

    def attend_cache(q, cache, k_new, v_new, pos=None):
        if pos is None:
            cache.append_lockstep(k_new, v_new)
            at = cache.length - k_new.shape[-2]
        else:
            cache.write_at(k_new, v_new, pos)
            at = pos
        return decode_attention(q, cache.k, cache.v, at)

    for m in modules:
        monkeypatch.setattr(m, "add_layer_norm", add_layer_norm)
        monkeypatch.setattr(m, "attend_cache", attend_cache)


def test_fused_decoder_layers_equal_the_unfused_pairs(asr_trees,
                                                      monkeypatch):
    """Two decoder layers (bf16 tree and caches) through a 4-token prefill,
    a host-position step and a device-position step: the logits and every
    cache bit-equal with and without the fused calls."""
    from janus_tpu_torch.models.params import cast_floating

    jcfg, tcfg, jp, enc = asr_trees
    assert tcfg.decoder_layers == 2
    params, _ = _port_asr(jp, int8=False)
    params = cast_floating(params, torch.bfloat16)
    enc = _t(enc).to(torch.bfloat16)
    prompt = torch.tensor([[256, 12, 40, 7]] * enc.shape[0])

    def run():
        state = t_asr.init_decode_state(params, tcfg, enc, max_len=8,
                                        dtype=torch.bfloat16)
        out = [t_asr.decoder_prefill(params, tcfg, prompt, state)[0]]
        out.append(t_asr.decoder_step(params, tcfg, prompt[:, 1], state)[0])
        out.append(t_asr._decoder_forward(params, tcfg, prompt[:, 2:3],
                                          torch.tensor(state.fill),
                                          state)[0])
        return out, state

    fused, fs = run()
    with monkeypatch.context() as m:
        _unfuse(m, t_asr)
        unfused, us = run()
    assert fs.fill == us.fill == 5
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)
    for a, b in zip(fs.self_caches, us.self_caches):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_fused_tts_blocks_equal_the_unfused_pairs(tts_tree, monkeypatch):
    """Two TTS blocks (bf16 tree and caches): the prefill and three AR
    steps at a device fill point, groups, flags and caches bit-equal with
    and without the fused calls."""
    from janus_tpu_torch.models.params import cast_floating

    cfg = TTSConfig(**TTS_KW, dtype="bfloat16")
    params = cast_floating(params_from_jax(tts_tree), torch.bfloat16)
    text, emo, spk = _prompt(2, seed=4)

    def run():
        first, done, state = t_tts.tts_prefill(
            params, cfg, _t(text), _t(emo), _t(spk), max_groups=6,
            stop_threshold=2.0, eager=True)
        out, prev, p = [first], first.float(), state.fill
        for g in range(3):
            prev, done = t_tts._step(params, cfg, state, prev, done,
                                     torch.tensor(g), 2.0,
                                     fill=torch.tensor(p + g))
            out += [prev, done]
        return out, state

    fused, fs = run()
    with monkeypatch.context() as m:
        _unfuse(m, t_tts)
        unfused, us = run()
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)
    for a, b in zip(fs.caches, us.caches):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


# -- the holder: device-position cache, accounting, path, trees -------------

def test_device_position_write_and_mask_equal_the_host_ones():
    rng = np.random.default_rng(0)
    host = KVCache.create((2,), 3, 10, 4)
    dev = KVCache.create((2,), 3, 10, 4)
    for t_new in (3, 1, 2):
        k, v = (torch.from_numpy(rng.standard_normal((2, 3, t_new, 4))
                                 .astype(np.float32)) for _ in range(2))
        pos = torch.tensor(host.length)
        dev.write_at(k, v, pos)
        assert torch.equal(fill_mask(pos, t_new, 10, "cpu"),
                           host.append_lockstep(k, v).valid_mask(t_new))
        assert torch.equal(dev.k, host.k) and torch.equal(dev.v, host.v)
    assert dev.length == 0


def test_replays_add_the_counts_the_capture_recorded(monkeypatch):
    """With the card's calls stood in for, a capture leaves the kernels'
    counts as the warm-up left them, and each replay adds the launches,
    operations and bytes the captured step counted."""
    k4, k2 = KERNELS["cross_attn_int8"], KERNELS["flash_attn"]

    def step():
        k4.launched(3.0, 5.0)
        k4.launched(3.0, 5.0)
        k2.launched(7.0, 1.0)

    class Stream:
        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    for k in (k4, k2):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "flops", 0.0)
        monkeypatch.setattr(k, "bytes", 0.0)
    g = StepGraph(step, torch.device("cuda"))
    # the warm-up launched; the capture did not
    assert (k4.launches, k4.flops, k4.bytes) == (2, 6.0, 10.0)
    assert (k2.launches, k2.flops, k2.bytes) == (1, 7.0, 1.0)
    assert g.counts == {k4: (2, 6.0, 10.0), k2: (1, 7.0, 1.0)}
    for _ in range(5):
        g.replay()
    assert Graph.replays == 5 and g.replays == 5
    assert (k4.launches, k4.flops, k4.bytes) == (12, 36.0, 60.0)
    assert (k2.launches, k2.flops, k2.bytes) == (6, 42.0, 6.0)


def test_a_holder_and_its_graph_form_no_cycle(monkeypatch):
    """A holder owns its ``StepGraph``, which holds the holder's step
    method weakly: dropping the holder frees it, with its graph, pool
    blocks and buffers, at once, not whenever the cyclic collector runs.
    The collector is off during a capture (freeing another graph there
    would tear that graph down inside the capture) and on again after."""
    import gc
    import weakref

    seen = []

    class Stream:
        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def graph(*a, **k):
        seen.append(gc.isenabled())
        yield

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(cuda, "graph", graph)

    class Holder:
        def __init__(self, device):
            self.steps = 0
            self.graph = StepGraph(self.step, device)

        def step(self):
            self.steps += 1

    for device, steps in ((torch.device("cpu"), 1), (torch.device("cuda"), 2)):
        h = Holder(device)
        h.graph.replay()
        assert h.steps == steps  # CPU: the replay; card: warm-up, capture
        gone = weakref.ref(h)
        collecting = gc.isenabled()
        gc.disable()
        try:
            del h
            assert gone() is None
        finally:
            if collecting:
                gc.enable()
    assert seen == [False] and gc.isenabled()


def test_the_path_follows_the_device_the_caller_and_the_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    from janus_tpu_torch.parallel.collectives import use_mesh

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert use_graphs(cuda) and not use_graphs(cuda, eager=True)
    assert not use_graphs(cpu)
    names = ("data", "model", "seq")
    for shape, graphed in (((1, 1, 1), True), ((2, 1, 1), False),
                           ((1, 2, 1), False)):
        mesh = DeviceMesh("cpu", torch.arange(2)[:int(np.prod(shape))]
                          .reshape(shape), mesh_dim_names=names,
                          _init_backend=False, _rank=0)
        with use_mesh(mesh):
            assert use_graphs(cuda) is graphed


def test_a_replaced_tree_is_never_served_by_an_old_holder():
    graphs = StepGraphs()
    tree = {"a": torch.zeros(2), "b": [torch.ones(3)]}
    made = []

    def build():
        made.append(object())
        return made[-1]

    with graphs.lock:
        first = graphs.holder(tree, "k", build)
        assert graphs.holder(tree, "k", build) is first
        assert graphs.holder(dict(tree), "k", build) is first  # same leaves
        tree2 = {"a": tree["a"], "b": [torch.ones(3)]}
        second = graphs.holder(tree2, "k", build)
        assert second is not first and len(made) == 2
        assert graphs.holder(tree, "k", build) is not first


def test_module_graphs_are_one_per_loop():
    assert step_graph.default_graphs("asr") is step_graph.default_graphs(
        "asr")
    assert step_graph.default_graphs("asr") is not step_graph.default_graphs(
        "tts")
