"""The receive side's captured programs on the CPU: :class:`SynthGraph`
(the prompt's prefill, the AR ``while_loop`` and the tail, vocoder, iSTFT
and resampler, one launch on the card) and the stream's holders (the
:class:`ARGraph` prefill, a chain of ``n`` steps a chunk, one emission
graph a chunk index over :class:`StreamGraph`'s static buffers), with
their steps run eagerly over their static buffers: against the JAX
package's compiled synthesis at ``tests/test_torch_synth.py``'s bar,
against the port's eager path bit for bit, the stream against the fused
path; the per-call Hann window made a constant; the holders' keys and
lifetime. On the card the same functions are captured in CUDA graphs
(``tests/test_torch_cuda.py``)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.common.protocol import JanusPacket as JJanusPacket
from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.models import tts as t_tts
from janus_tpu_torch.models import vocoder as t_voc
from janus_tpu_torch.models.params import params_from_jax
from janus_tpu_torch.ops import stft as t_stft
from janus_tpu_torch.runtime import streaming_tts, synthesizer
from janus_tpu_torch.runtime.step_graph import StepGraphs
from janus_tpu_torch.runtime.streaming_tts import (StreamGraph,
                                                   StreamingSynthesizer)
from janus_tpu_torch.runtime.synthesizer import SynthGraph, Synthesizer

# the geometry of the JAX package's tests/test_synthesis.py (two layers,
# 64 wide), 24 kHz so that the resampler runs
SMALL = {"tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
         "tts.n_mels": 16, "tts.max_text_tokens": 32,
         "tts.max_mel_frames": 32, "vocoder.d_model": 64,
         "vocoder.layers": 2, "vocoder.n_fft": 256,
         "vocoder.hop_length": 64, "vocoder.sample_rate": 24_000}
TEXTS = ("alpha bravo", "fox golf hotel kilo lima mike")


def _pcm(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0


def _graphed(monkeypatch):
    """Name the graph path on the CPU: the holders run their steps
    eagerly over their static buffers."""
    for mod in (synthesizer, streaming_tts):
        monkeypatch.setattr(mod, "use_graphs",
                            lambda device, eager=False: not eager)


@pytest.fixture(scope="module")
def pair():
    """The JAX synthesizer (random weights from its seed 0, a unit default
    speaker vector) and the port's on the same trees."""
    vec = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    vec /= np.linalg.norm(vec)
    jsyn = JSynthesizer(JJanusConfig().override(**SMALL),
                        default_speaker_vec=vec)
    trees = {k: params_from_jax(getattr(jsyn, k)) for k in (
        "tts_params", "vocoder_params", "speaker_params")}
    return jsyn, trees, vec


def _port(pair, **kw) -> Synthesizer:
    _, trees, vec = pair
    return Synthesizer(JanusConfig().override(**SMALL), **trees,
                       default_speaker_vec=vec, device="cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Each synthesis here is a few thousand small ops: one thread, as in
    ``tests/test_torch_encode_graph.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_holder_synthesis_matches_jax_and_the_eager_path(pair, monkeypatch):
    """``synthesize`` through the :class:`SynthGraph` of its bucket: the
    JAX package's ``_synth_jit`` bytes within 1e-3 of full scale with the
    same sample count, and the eager path's bytes exactly; one holder a
    bucket, one loop run a synthesis, its trips read after the samples."""
    jsyn = pair[0]
    eager = _port(pair, eager=True)
    _graphed(monkeypatch)
    syn = _port(pair)
    assert syn._graphed() and not eager._graphed()
    for text in TEXTS:
        prosody = {"pitch": "High", "energy": "Loud"}
        got = syn.synthesize(JanusPacket(text=text, prosody=prosody))
        ref = jsyn.synthesize(JJanusPacket(text=text, prosody=prosody))
        assert len(got) == len(ref) > 0
        assert np.abs(_pcm(got) - _pcm(ref)).max() <= 1e-3
        assert got == eager.synthesize(JanusPacket(text=text,
                                                   prosody=prosody))
    holders = syn._graphs.holders("synth")
    assert [h.ar.text_ids.shape for h in holders] == [(1, 16), (1, 32)]
    assert all(h.loop.runs == 1 and h.loop.before is h.ar.prefill_graph
               and h.loop.after is h.tail for h in holders)
    assert syn._graphs.steps == sum(h.loop.trips_run for h in holders) > 0
    assert not eager._graphs.holders()


def test_synth_impl_batch_is_the_eager_one_bit_for_bit(pair, monkeypatch):
    """Two lanes through one holder, twice with other prompts in between:
    ``wav48`` and ``n48`` equal ``_synth_impl`` issued op by op, bit for
    bit (nothing left over from the call before)."""
    eager = _port(pair, eager=True)
    _graphed(monkeypatch)
    syn = _port(pair)
    rng = np.random.default_rng(3)
    spk = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    for seed in (0, 1, 0):
        text = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (2, 8)))
        emo = torch.tensor([seed, 4])
        with torch.no_grad(), syn._graphs.lock:
            wav, n48 = syn._synth_impl(text, emo, spk)
            wav, n48 = wav.clone(), n48.clone()
        want = eager._synth_impl(text, emo, spk)
        assert wav.dtype == want[0].dtype and torch.equal(wav, want[0])
        assert n48.dtype == want[1].dtype and torch.equal(n48, want[1])
    (h,) = syn._graphs.holders("synth")
    assert h.loop.runs == 3 and h.ar.epoch == 3 and h.ar.steps is None


def _stop_at(params, cfg, step):
    """The port's tree whose stop head fires at AR step ``step`` in every
    lane (at none for None), as ``tests/test_torch_decode_graphs.py``
    pushes the position row that step feeds along one channel."""
    d = cfg.tts.d_model
    pos = params["pos_emb"].clone()
    if step is not None:
        pos[t_tts.audio_pos_base(cfg.tts) + step - 1, 5] += 200.0
    w = torch.zeros((d, 1))
    w[5, 0] = 1.0
    return {**params, "pos_emb": pos,
            "stop_head": {"w": w, "b": torch.full((1,), -6.0)}}


# a stop at step 5 (group 6 of a 16-group budget) and none (the cap ends
# the stream); 5-group chunks so that the chunks end inside the halo
@pytest.mark.parametrize("stop", [5, None], ids=["stop5", "never"])
def test_captured_stream_equals_fused_and_eager(pair, monkeypatch, stop):
    """The stream through its holders (the prefill replayed, a chain of
    steps a chunk, one emission a chunk index over the static buffers)
    equals the eager stream bit for bit and the fused synthesis within
    ``tests/test_torch_synth.py``'s 3e-5, twice on one streamer."""
    cfg = JanusConfig().override(**{**SMALL,
                                    "tts.max_seconds_per_text_token": 10.0})
    _, trees, vec = pair
    tts = _stop_at(trees["tts_params"], cfg, stop)
    kw = dict(tts_params=tts, vocoder_params=trees["vocoder_params"],
              chunk_groups=5, device="cpu")
    eager = StreamingSynthesizer(cfg, eager=True, **kw)
    fused = Synthesizer(cfg, tts_params=tts,
                        vocoder_params=trees["vocoder_params"],
                        speaker_params=trees["speaker_params"],
                        default_speaker_vec=vec, device="cpu")
    _graphed(monkeypatch)
    s = StreamingSynthesizer(cfg, **kw)
    text = "stream me"
    # the fused path's float samples, as Synthesizer._run_tts cuts them
    ids = s.tokenizer.encode(text)
    padded = np.full((1, t_tts.text_bucket(len(ids), 32)), s.tokenizer.pad,
                     np.int64)
    padded[0, :len(ids)] = ids
    wav, n48 = fused._synth_impl(
        torch.from_numpy(padded),
        torch.tensor([t_tts.emotion_id("relaxed")]),
        torch.from_numpy(vec)[None])
    ref = wav[0, :int(n48[0])].numpy()
    frames = 2 * (16 if stop is None else stop + 1)
    assert len(ref) == frames * 64 * 2
    for _ in range(2):
        chunks = list(s.stream(text, "relaxed", speaker=vec))
        want = list(eager.stream(text, "relaxed", speaker=vec))
        assert len(chunks) == len(want) > 1
        assert all(np.array_equal(a, b) for a, b in zip(chunks, want))
        got = np.concatenate(chunks)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    (em,) = s._graphs.holders("emit")
    (ar,) = s._graphs.holders("ar")
    assert em.epoch == 2 and len(em.side_graphs) == len(em.plan)
    assert ar.prefill_graph.replays == 2 and ar.graph.replays == 0
    assert sorted(ar.chains) == [5]


def test_a_chunk_of_n_steps_equals_n_single_steps(pair):
    """A chain of ``n`` steps leaves the holder as ``n`` single steps do
    (caches, groups, flags, counters); a chunk past the budget runs the
    steps that fit, then the first refused one raises, as single steps
    would."""
    cfg = JanusConfig().override(**SMALL).tts
    tts = pair[1]["tts_params"]
    rng = np.random.default_rng(5)
    text = torch.from_numpy(rng.integers(0, 256, (2, 8)))
    emo = torch.tensor([1, 3])
    spk = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    states = []
    for chained in (True, False):
        graphs = StepGraphs()
        with graphs.lock:
            h = t_tts.ar_graph(graphs, tts, cfg, 2, 11, 16, 2.0,
                               torch.device("cpu"), 261, torch.float32)
            h.prefill(text, emo, spk)
            for n in (4, 7):
                if chained:
                    h.run_steps(n)
                else:
                    for _ in range(n):
                        h.advance()
        assert h.steps == 11 and sorted(h.chains) == ([4, 7] if chained
                                                      else [])
        states.append([t.clone() for t in (
            h.out, h.dones, h.n_groups, h.prev, h.done, h.group)]
            + [t.clone() for c in h.caches for t in (c.k, c.v)])
        if chained:
            assert graphs.steps == 11
            with pytest.raises(ValueError, match="KV cache overflow"):
                h.run_steps(6)
            assert h.steps == 16 and 5 in h.chains
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_cached_hann_window_equals_the_per_call_one():
    """The window is made once per (n_fft, dtype, device) with the values
    the per-call upload had, bit for bit."""
    cpu = torch.device("cpu")
    for n, dtype in ((256, torch.float32), (1024, torch.float32),
                     (400, torch.bfloat16)):
        w = t_stft.hann_window(n, dtype=dtype, device=cpu)
        assert t_stft.hann_window(n, dtype=dtype, device="cpu") is w
        assert torch.equal(w, torch.from_numpy(t_stft._hann_np(n)).to(dtype))
    spec = torch.randn(2, 9, 129, dtype=torch.complex64)
    vcfg = JanusConfig().override(**SMALL).vocoder
    win = torch.from_numpy(t_stft._hann_np(256))
    assert torch.equal(t_voc.spectra_to_waveform(vcfg, spec), t_stft.istft(
        torch.cat([spec, spec[:, -1:].expand(2, 4, 129)], 1), 256, 64,
        window=win)[..., :9 * 64])


def test_distinct_keys_give_distinct_holders(pair, monkeypatch):
    """A :class:`SynthGraph` per (bucket, batch, speaker dtype or none),
    each with its own :class:`ARGraph`; a repeated key gives the same
    holder; the streamer's prefill holders by (bucket, speaker) beside its
    one :class:`StreamGraph`."""
    _graphed(monkeypatch)
    syn = _port(pair)
    keys = [(8, 1, None), (16, 1, None), (8, 2, None), (8, 1, torch.float32)]
    with syn._graphs.lock:
        holders = [syn.synth_graph(*k) for k in keys]
        assert syn.synth_graph(8, 1, None) is holders[0]
    assert len({id(h) for h in holders}) == len({id(h.ar) for h in holders})
    assert len({id(h) for h in holders}) == len(keys)
    assert [tuple(h.ar.text_ids.shape) for h in holders] == [
        (1, 8), (1, 16), (2, 8), (1, 8)]
    assert [h.ar.speaker is None for h in holders] == [True] * 3 + [False]
    assert all(isinstance(h, SynthGraph) for h in holders)
    s = syn.streamer()
    s.warmup(speaker=torch.float32)
    n_buckets = len(t_tts.text_buckets(32))
    assert len(s._graphs.holders("ar")) == n_buckets
    assert all(h.speaker is not None for h in s._graphs.holders("ar"))
    (em,) = s._graphs.holders("emit")
    assert isinstance(em, StreamGraph)
    with s._graphs.lock:
        assert s.ar_graph(8, None) is not s.ar_graph(8, torch.float32)
        assert s.stream_graph() is em


def test_a_receive_holder_and_its_graphs_form_no_cycle(pair, monkeypatch):
    """A :class:`SynthGraph` and a :class:`StreamGraph` keep what they need
    of their owner, not the owner, and their graphs hold their steps
    weakly: dropping the synthesizer frees its holders at once, without
    the cyclic collector."""
    _graphed(monkeypatch)
    syn = _port(pair)
    with syn._graphs.lock:
        holder = syn.synth_graph(8, 1, None)
    s = syn.streamer()
    with s._graphs.lock:
        em = s.stream_graph()
        ar = s.ar_graph(8, None)
    gone = [weakref.ref(o) for o in (syn, holder, holder.ar, s, em, ar)]
    del holder, em, ar, s
    collecting = gc.isenabled()
    gc.disable()
    try:
        del syn
        assert all(r() is None for r in gone)
    finally:
        if collecting:
            gc.enable()
