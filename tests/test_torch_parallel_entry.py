"""The serving entry points on meshes against the JAX package's on the CPU:
``Synthesizer`` tensor-parallel at model 2, ``SemanticEncoder`` at seq 2
and at data 2 x model 2 x seq 2, and the new entry points' need of a card
unless the CPU is asked for.

Each multi-rank case runs on gloo ranks through ``run_ranks``; the JAX
side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``. JAX is imported inside the tests only, so that no
rank loads it.

Bars are the JAX tests' own: PCM within one int16 LSB
(``tests/test_parallel.py``), text and prosody equal and f0 within 0.5 Hz
(``tests/test_scaling.py``), each against the JAX package and against the
port with ``mesh=None``.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.audio.synthetic import voiced_phrase
from janus_tpu_torch.common.config import JanusConfig, MeshConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.parallel.launch import run_ranks
from janus_tpu_torch.parallel.mesh import build_mesh
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.synthesizer import Synthesizer

SYNTH_OVERRIDES = {
    "tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
    "tts.n_mels": 16, "tts.max_text_tokens": 16, "tts.max_mel_frames": 16,
    "vocoder.n_fft": 64, "vocoder.hop_length": 16, "vocoder.d_model": 32,
    "vocoder.layers": 2, "vocoder.sample_rate": 16_000,
}
ENCODER_OVERRIDES = {
    "asr.d_model": 64, "asr.encoder_layers": 2, "asr.decoder_layers": 1,
    "asr.num_heads": 4, "asr.n_mels": 16, "asr.vocab_size": 261,
    "asr.max_source_positions": 256, "asr.max_target_positions": 32,
    "asr.max_decode_tokens": 4,
}
PACKET = dict(text="hello there", prosody={"energy": "Loud", "pitch": "High"},
              timestamp=0.0)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _synth_rank(tts_np, voc_np):
    syn = Synthesizer(JanusConfig().override(**SYNTH_OVERRIDES),
                      tts_params=tts_np, vocoder_params=voc_np,
                      device="cpu",
                      mesh=build_mesh(MeshConfig(data=1, model=2, seq=1)))
    pkt = JanusPacket(**PACKET)
    return syn.synthesize(pkt), b"".join(syn.synthesize_streaming(pkt))


def test_tensor_parallel_synthesis_matches_jax_and_unsharded():
    """model 2: the TTS and vocoder weights split by the rules, every rank
    synthesizes the same PCM, within one int16 LSB of the JAX package's
    tensor-parallel synthesizer and of the port's with ``mesh=None`` (the
    stop head pinned negative, as the JAX test does, so that the length is
    not decided by a logit at the threshold)."""
    import jax.numpy as jnp

    from janus_tpu.common.config import JanusConfig as JJanusConfig
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.common.protocol import JanusPacket as JJanusPacket
    from janus_tpu.models import tts as j_tts
    from janus_tpu.models import vocoder as j_voc
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer

    jcfg = JJanusConfig().override(**SYNTH_OVERRIDES)
    tts_params = j_tts.init_tts(0, jcfg.tts, text_vocab=261)
    tts_params["stop_head"]["b"] = jnp.full_like(
        tts_params["stop_head"]["b"], -5.0)
    voc_params = j_voc.init_vocoder(1, jcfg.vocoder, n_mels=jcfg.tts.n_mels)
    tts_np, voc_np = _np_tree(tts_params), _np_tree(voc_params)
    j_pcm = np.frombuffer(JSynthesizer(
        jcfg, tts_params=tts_params, vocoder_params=voc_params,
        mesh=j_build_mesh(JMeshConfig(data=1, model=2, seq=1))).synthesize(
            JJanusPacket(**PACKET)), dtype=np.int16)
    ref = np.frombuffer(Synthesizer(
        JanusConfig().override(**SYNTH_OVERRIDES), tts_params=tts_np,
        vocoder_params=voc_np, device="cpu").synthesize(
            JanusPacket(**PACKET)), dtype=np.int16)
    assert len(j_pcm) > 0
    for fused, streamed in run_ranks(_synth_rank, 2, device="cpu",
                                     args=(tts_np, voc_np), timeout=120):
        pcm = np.frombuffer(fused, dtype=np.int16)
        assert pcm.shape == j_pcm.shape == ref.shape
        np.testing.assert_allclose(pcm, j_pcm, atol=1)
        np.testing.assert_allclose(pcm, ref, atol=1)
        # the streamed path runs under the mesh too
        np.testing.assert_allclose(np.frombuffer(streamed, dtype=np.int16),
                                   pcm, atol=1)


def _phrases():
    return [voiced_phrase(seconds=0.7, f0=120.0 + 40 * i, amp=0.2, seed=i)
            for i in range(4)]


def _encoder_rank(params_np, mesh_shape):
    enc = SemanticEncoder(JanusConfig().override(**ENCODER_OVERRIDES),
                          asr_params=params_np, buckets=(48_000,),
                          device="cpu",
                          mesh=build_mesh(MeshConfig(*mesh_shape)))
    return enc.encode_batch(_phrases())


@pytest.mark.parametrize("mesh_shape", [(1, 1, 2), (2, 2, 2)])
def test_encoder_meshes_match_jax_and_unsharded(mesh_shape):
    """seq 2 (ring attention), and data 2 x model 2 x seq 2 (each data
    rank's frontend on its own lanes, tensor-parallel recognizer, ring
    attention, results gathered): every rank's results against the JAX
    package's unsharded encoder and the port's with ``mesh=None``."""
    from janus_tpu.common.config import JanusConfig as JJanusConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.runtime.codec import SemanticEncoder as JEncoder

    jcfg = JJanusConfig().override(**ENCODER_OVERRIDES)
    params_np = _np_tree(j_asr.init_asr(0, jcfg.asr))
    j_ref = JEncoder(jcfg, buckets=(48_000,)).encode_batch(_phrases())
    ref = SemanticEncoder(JanusConfig().override(**ENCODER_OVERRIDES),
                          asr_params=params_np, buckets=(48_000,),
                          device="cpu").encode_batch(_phrases())
    n = int(np.prod(mesh_shape))
    for out in run_ranks(_encoder_rank, n, device="cpu",
                         args=(params_np, mesh_shape), timeout=180):
        assert len(out) == len(ref) == len(j_ref)
        for o, r, j in zip(out, ref, j_ref):
            assert o["text"] == r["text"] == j["text"]
            assert o["prosody"] == r["prosody"] == j["prosody"]
            assert abs(o["f0"] - r["f0"]) < 0.5
            assert abs(o["f0"] - j["f0"]) < 0.5


@pytest.mark.parametrize("entry", ["run_ranks", "analyze_encode_scaling",
                                   "measure_wallclock_scaling",
                                   "scaling_main", "initialize_from_env"])
def test_parallel_entry_points_need_a_card(monkeypatch, entry):
    """The card is the default: without one these raise, unless the CPU
    is asked for."""
    from janus_tpu_torch.eval import scaling
    from janus_tpu_torch.parallel.distributed import initialize_from_env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "run_ranks": lambda: run_ranks(_phrases, 1),
        "analyze_encode_scaling": lambda: scaling.analyze_encode_scaling(
            device_counts=(1,)),
        "measure_wallclock_scaling":
            lambda: scaling.measure_wallclock_scaling(device_counts=(1,)),
        "scaling_main": lambda: scaling.main([]),
        "initialize_from_env": lambda: initialize_from_env(env={
            "JANUS_COORDINATOR_ADDRESS": "localhost:1",
            "JANUS_NUM_PROCESSES": "1", "JANUS_PROCESS_ID": "0"}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    if entry == "run_ranks":
        assert len(run_ranks(_phrases, 1, device="cpu", timeout=60)[0]) == 4
