"""The decode loops' exit decided as the JAX package's ``lax.while_loop``
decides it, on the CPU: :class:`~janus_tpu_torch.runtime.step_graph.
LoopGraph` (on the card a WHILE graph node around the captured step,
its condition ``~all(done)`` within the budget tested before each step)
run eagerly over the holders' static buffers, at forced exits (every lane emits eot,
or stops, at step 1, 2, 7, 8, 9 or never), against the eager loops bit
for bit and against the JAX package: the recognizer's tokens equal and
its ``trips`` equal to the ``while_loop``'s trip count, the TTS mel within
1e-4 with ``n_frames`` and ``trips`` equal; the kernel accounting of a
run by its trips; ``encode_batch_submit`` against ``encode_batch``; a
shape whose loop would overflow raising at the holder's construction.
Small sizes, as ``tests/test_torch_decode_graphs.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_graphs import (_GEOM, EOT, TTS_KW, _asr_eot_at,
                                      _tts_stop_at)

from janus_tpu.common.config import ASRConfig as JASRConfig
from janus_tpu.common.config import TTSConfig as JTTSConfig
from janus_tpu.models import asr as j_asr
from janus_tpu.models import tts as j_tts
from janus_tpu_torch.common.config import ASRConfig, TTSConfig
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models import tts as t_tts
from janus_tpu_torch.models.params import (params_from_jax,
                                           prepare_decode_params)
from janus_tpu_torch.ops.cuda_build import KERNELS
from janus_tpu_torch.ops.loop_graph import loop_condition_plain
from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepGraph,
                                                StepGraphs)

STOPS = [1, 2, 7, 8, 9, None]
IDS = ["1", "2", "7", "8", "9", "never"]
MAX_NEW = 16
J_GREEDY = jax.jit(j_asr.greedy_decode, static_argnames=(
    "cfg", "eot_id", "max_new"))
J_TTS = jax.jit(j_tts.tts_generate, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def asr_case():
    """The scaled random tree of ``test_torch_decode_graphs.py`` and an
    encoder output of it (two lanes)."""
    jcfg = JASRConfig(**_GEOM)
    jp = jax.tree.map(lambda a: np.asarray(a) * 4.0 if a.ndim > 1
                      else np.asarray(a), j_asr.init_asr(0, jcfg))
    mel = np.random.default_rng(2).standard_normal((2, 64, 80)).astype(
        np.float32)
    enc = np.array(j_asr.encode_audio(jax.tree.map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(mel)))
    return jcfg, ASRConfig(**_GEOM), jp, enc


@pytest.fixture(scope="module")
def tts_base():
    return j_tts.init_tts(0, JTTSConfig(**TTS_KW), text_vocab=261)


def _while_loop_trips(tokens: np.ndarray, max_new: int) -> int:
    """The JAX ``while_loop``'s trip count from its tokens: the first step
    at which every lane has emitted eot (0 if all did in the prefill),
    capped at ``max_new - 1``."""
    first = [int(np.argmax(row == EOT)) if (row == EOT).any() else max_new
             for row in tokens]
    return min(max(first), max_new - 1)


@pytest.mark.parametrize("stop", STOPS, ids=IDS)
def test_greedy_loop_exits_where_the_while_loop_does(asr_case, stop):
    jcfg, tcfg, jp, enc = asr_case
    jp = _asr_eot_at(jp, stop)
    tp = prepare_decode_params(params_from_jax(jp))
    prompt = np.full((2, 1), 256, np.int32)
    ref = np.asarray(J_GREEDY(jax.tree.map(jnp.asarray, jp), cfg=jcfg,
                              enc=jnp.asarray(enc),
                              prompt=jnp.asarray(prompt), eot_id=EOT,
                              max_new=MAX_NEW))
    e, p = torch.from_numpy(enc), torch.from_numpy(prompt).long()
    eager = t_asr.greedy_decode(tp, tcfg, e, p, EOT, max_new=MAX_NEW)
    graphs = StepGraphs()
    with graphs.lock:
        h = t_asr.greedy_graph(graphs, tp, tcfg, 2, enc.shape[1],
                               torch.float32, 1, MAX_NEW, torch.float32,
                               False, EOT, torch.device("cpu"))
        tokens, trips = h.decode(e, p)
    assert torch.equal(tokens, eager)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    want = _while_loop_trips(ref, MAX_NEW)
    assert want == (MAX_NEW - 1 if stop is None else stop)
    assert trips.dtype == torch.int32 and int(trips) == want
    assert h.loop.limit == MAX_NEW - 1
    # the step graph ran none of them: the loop is its own graph
    assert h.graph.replays == 0 and h.loop.runs == 1


@pytest.mark.parametrize("stop", STOPS, ids=IDS)
def test_ar_loop_exits_where_the_while_loop_does(tts_base, stop):
    jp = _tts_stop_at(tts_base, stop)
    jc = JTTSConfig(**TTS_KW, dtype="float32")
    tc = TTSConfig(**TTS_KW, dtype="float32")
    tp = params_from_jax(jp)
    rng = np.random.default_rng(7)
    text = rng.integers(0, 256, size=(2, 8)).astype(np.int32)
    emo = rng.integers(0, len(t_tts.EMOTIONS), size=(2,)).astype(np.int32)
    spk = rng.standard_normal((2, TTS_KW["d_model"])).astype(np.float32)
    ref_mel, ref_n = J_TTS(jp, jc, jnp.asarray(text), jnp.asarray(emo),
                           speaker=jnp.asarray(spk))
    args = [torch.from_numpy(a) for a in (text, emo, spk)]
    eager = t_tts.tts_generate(tp, tc, *args[:2], speaker=args[2])
    graphs = StepGraphs()
    mel, n_frames = t_tts._generate_graphed(tp, tc, *args, 16, 261, 0.5,
                                            graphs)
    assert torch.equal(mel, eager[0]) and torch.equal(n_frames, eager[1])
    np.testing.assert_array_equal(n_frames.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=0,
                               atol=1e-4)
    # the while_loop's trips: every lane's groups past the first
    want = int(np.asarray(ref_n).max()) // tc.reduction - 1
    assert want == (15 if stop is None else stop)
    (loop,) = graphs.loops("ar")
    assert loop.limit == 15 and loop.runs == 1
    assert graphs.steps == loop.trips_run == want
    (h,) = graphs.holders("ar")
    assert h.steps is None and h.graph.replays == 0


def test_loop_graph_runs_bodies_until_done_or_the_limit():
    """The loop's structure on the CPU: bodies while any lane is live,
    at most ``limit``; ``trips`` as ``run`` returns it; each run accounted
    by its trips (``account``, or ``defer`` then ``settle``): the step's
    counts times the bodies that ran; the step graph's replays untouched.
    The condition's plain version at its edges."""
    done = torch.zeros(3, dtype=torch.bool)
    x = torch.zeros((), dtype=torch.int32)
    stop = torch.zeros((), dtype=torch.int32)

    def step():
        x.add_(1)
        torch.logical_or(done, x >= stop, out=done)

    k4 = KERNELS["cross_attn_int8"]
    for n in (1, 7, 8):
        lp = LoopGraph(StepGraph(step, torch.device("cpu")), done, n)
        lp.counts = {k4: (2, 3.0, 5.0)}  # as a capture would record them
        for k in (0, 1, 5, 100):
            stop.fill_(k)
            x.zero_()
            done.fill_(k == 0)
            lp.trips.zero_()
            trips = lp.run()
            assert int(trips) == int(x) == min(k, n) * (k > 0)
            before = k4.launches, k4.flops, k4.bytes
            lp.defer(trips)
            lp.settle()
            t = int(trips)
            assert (k4.launches, k4.flops, k4.bytes) == (
                before[0] + 2 * t, before[1] + 3.0 * t, before[2] + 5.0 * t)
        assert lp.step_graph.replays == 0 and lp.runs == 4
        k4.launches = k4.flops = k4.bytes = 0
    live = torch.tensor([True, False, True])
    for trips, limit, add, go in ((0, 1, 0, True), (1, 1, 0, False),
                                  (0, 1, 1, False), (6, 8, 1, True)):
        t, g = loop_condition_plain(
            live, torch.tensor(trips, dtype=torch.int32), limit, add)
        assert int(t) == trips + add and bool(g) is go
    t, g = loop_condition_plain(torch.ones(3, dtype=torch.bool),
                                torch.zeros((), dtype=torch.int32), 5)
    assert not bool(g)


def test_overflowing_loops_raise_at_the_holders_construction(asr_case,
                                                             tts_base):
    """A greedy loop that would read past the position table (32 rows;
    its last step at position prompt + max_new - 2) raises when its
    holder is built, before any capture: max_new 32 at a one-token prompt
    reads position 31 and is built; 33 is refused. The AR loop likewise
    at the position table's last row."""
    _, tcfg, jp, _ = asr_case
    tp = prepare_decode_params(params_from_jax(jp))
    graphs = StepGraphs()
    with graphs.lock:
        t_asr.greedy_graph(graphs, tp, tcfg, 1, 4, torch.float32, 1, 32,
                           torch.float32, False, EOT, torch.device("cpu"))
        with pytest.raises(ValueError, match="position 32 lies outside"):
            t_asr.greedy_graph(graphs, tp, tcfg, 1, 4, torch.float32, 1, 33,
                               torch.float32, False, EOT,
                               torch.device("cpu"))
    tc = TTSConfig(**TTS_KW, dtype="float32")
    tts = params_from_jax(tts_base)
    rows = tts["pos_emb"].shape[0]
    fits = rows - t_tts.audio_pos_base(tc) + 1
    with graphs.lock:
        t_tts.ar_graph(graphs, tts, tc, 1, 11, fits, 0.5,
                       torch.device("cpu"))
        with pytest.raises(ValueError, match=f"position {rows} lies "
                           f"outside the position table"):
            t_tts.ar_graph(graphs, tts, tc, 1, 11, fits + 1, 0.5,
                           torch.device("cpu"))


def test_submit_result_equals_encode_batch(monkeypatch):
    """``encode_batch_submit(...).result()`` through the captured front and
    the loop graph (their steps eager on the CPU) equals ``encode_batch``
    and the eager encoder; the loop's trips are accounted at the harvest;
    the pinned twins go round, one for each encode that may be in
    flight."""
    from test_torch_encode_graph import _encoder, _phrases

    from janus_tpu_torch.runtime import codec

    eager = _encoder("int16", "dense", eager=True)
    monkeypatch.setattr(codec, "use_graphs", lambda device, eager=False:
                        not eager)
    enc = _encoder("int16", "dense")
    assert enc._graphed() and not eager._graphed()
    slots = enc.cfg.runtime.max_inflight_encodes + 1
    for seed in (0, 1, 0):
        phrases = _phrases(seed)
        pending = enc.encode_batch_submit(phrases)
        (loop,) = enc._graphs.loops("greedy")
        before = loop.trips_run
        got = pending.result()
        assert got == pending.result() == enc.encode_batch(phrases)
        assert got == eager.encode_batch(phrases)
        assert loop.trips_run > before
    (h,) = enc._graphs.holders("encode")
    assert len(h.twins) == slots and h.uploads == 6
    assert h.graph.replays == 6 and loop.runs == 6
