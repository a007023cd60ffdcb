"""The port's ``Trainer`` on meshes against the JAX package's on the CPU:
an ASR step on a replica 2 x data 2 x model 2 hybrid mesh (the loss
against JAX's at rtol 1e-4, the JAX test's bar, and a second step lower),
and one step of the ASR and TTS trainers at data 2 x model 4, held
against the JAX package's sharded trainer.

Each multi-rank case runs on 8 gloo ranks through ``run_ranks``; the JAX
side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``. JAX is imported inside the tests only, so that no
rank loads it.

One step's loss and gradient norm are held to rtol 1e-5 (the loss bar
of ``tests/test_torch_train.py``; the norm is where a gradient counted
twice would show). The parameters after the step are held to a tenth of
the step size: Adam's first update is ``g / (|g| + 1e-8)`` per element,
which turns the rounding of a gradient element near 1e-8 into a fraction
of a step whatever the layout (the one-device port and the JAX package
differ by as much). That update is blind to the gradient's scale, which
the norm checks.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.common.config import ASRConfig, MeshConfig, TTSConfig
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           params_from_jax)
from janus_tpu_torch.parallel.distributed import build_hybrid_mesh
from janus_tpu_torch.parallel.launch import run_ranks
from janus_tpu_torch.parallel.mesh import build_mesh
from janus_tpu_torch.parallel.sharding import (ASR_PARTITION_RULES,
                                               TTS_PARTITION_RULES,
                                               gather_params)
from janus_tpu_torch.train import losses
from janus_tpu_torch.train.trainer import Trainer

HYBRID_ASR_KW = dict(n_mels=16, d_model=64, encoder_layers=2,
                     decoder_layers=2, num_heads=8, vocab_size=300,
                     max_source_positions=32, max_target_positions=16)
ASR_KW = dict(n_mels=16, d_model=64, encoder_layers=2, decoder_layers=2,
              num_heads=8, vocab_size=261, max_source_positions=64,
              max_target_positions=32)
TTS_KW = dict(d_model=64, layers=2, num_heads=4, n_mels=16,
              max_text_tokens=16, max_mel_frames=16)
LR = 1e-3


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _loss_fn(kind):
    if kind == "asr":
        cfg = ASRConfig(**ASR_KW, dtype="float32")
        return lambda p, *b: losses.asr_loss(p, cfg, *b)
    if kind == "hybrid":
        cfg = ASRConfig(**HYBRID_ASR_KW, dtype="float32")
        return lambda p, *b: losses.asr_loss(p, cfg, *b)
    cfg = TTSConfig(**TTS_KW)
    return lambda p, *b: losses.tts_loss(p, cfg, *b, text_vocab=261)


def _train_rank(kind, params_np, batch, steps):
    """``steps`` Trainer steps on ``kind``'s mesh: the losses, the
    gradient norms and, after the steps, the whole parameter tree
    (gathered)."""
    if kind == "hybrid":
        mesh = build_hybrid_mesh(replica=2, data=2, model=2, seq=1)
    else:
        mesh = build_mesh(MeshConfig(data=2, model=4, seq=1))
    rules = TTS_PARTITION_RULES if kind == "tts" else ASR_PARTITION_RULES
    tr = Trainer(_loss_fn(kind), learning_rate=LR, mesh=mesh, rules=rules)
    state = tr.create_state(params_from_jax(params_np))
    step_losses, norms = [], []
    for _ in range(steps):
        state, m = tr.train_step(state, *batch)
        step_losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return step_losses, norms, gather_params(state.params, mesh, rules)


def test_trainer_on_hybrid_mesh_matches_jax():
    """replica 2 x data 2 x model 2: the first step's loss is the JAX
    package's loss of the same weights on the same batch (rtol 1e-4, the
    bar of ``tests/test_distributed.py``), and the second step's is
    lower."""
    import jax
    import jax.numpy as jnp

    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.train.losses import asr_loss as j_asr_loss

    jcfg = JASRConfig(**HYBRID_ASR_KW)
    jp = j_asr.init_asr(0, jcfg)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((8, 64, jcfg.n_mels)).astype(np.float32)
    tokens = rng.integers(0, 299, size=(8, 8)).astype(np.int32)
    mask = np.ones_like(tokens, dtype=np.float32)
    j_loss, _ = jax.jit(lambda p, *b: j_asr_loss(p, jcfg, *b))(
        jp, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask))
    for step_losses, _, _ in run_ranks(
            _train_rank, 8, device="cpu", timeout=180,
            args=("hybrid", _np_tree(jp), (mel, tokens, mask), 2)):
        assert np.isfinite(step_losses).all()
        np.testing.assert_allclose(step_losses[0], float(j_loss), rtol=1e-4)
        assert step_losses[1] < step_losses[0]


def _asr_case():
    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.parallel.sharding import ASR_PARTITION_RULES as j_rules
    from janus_tpu.train.losses import asr_loss as j_asr_loss

    jcfg = JASRConfig(**ASR_KW)
    rng = np.random.default_rng(3)
    batch = (rng.standard_normal((4, 128, 16)).astype(np.float32),
             rng.integers(0, 260, size=(4, 12)).astype(np.int32),
             np.ones((4, 12), dtype=np.float32))
    return (j_asr.init_asr(0, jcfg),
            lambda p, *b: j_asr_loss(p, jcfg, *b), j_rules, batch)


def _tts_case():
    from janus_tpu.common.config import TTSConfig as JTTSConfig
    from janus_tpu.models import tts as j_tts
    from janus_tpu.parallel.sharding import TTS_PARTITION_RULES as j_rules
    from janus_tpu.train.losses import tts_loss as j_tts_loss

    jcfg = JTTSConfig(**TTS_KW)
    rng = np.random.default_rng(4)
    batch = (rng.integers(0, 255, size=(4, 8)).astype(np.int32),
             rng.integers(0, 8, size=(4,)).astype(np.int32),
             rng.standard_normal((4, 6, jcfg.reduction * jcfg.n_mels)
                                 ).astype(np.float32),
             np.ones((4, 6), dtype=np.float32))
    return (j_tts.init_tts(0, jcfg, text_vocab=261),
            lambda p, *b: j_tts_loss(p, jcfg, *b, text_vocab=261), j_rules,
            batch)


@pytest.mark.parametrize("kind", ["asr", "tts"])
def test_dp_tp_train_step_matches_jax(kind):
    """data 2 x model 4, one step from the same weights on the same batch:
    the loss and the gradient norm (rtol 1e-5) and every parameter
    afterwards (a tenth of the step size) against the JAX package's
    sharded trainer."""
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.models.params import flatten_with_paths as j_flatten
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.train.trainer import Trainer as JTrainer

    jp, j_loss, j_rules, batch = (_asr_case if kind == "asr"
                                  else _tts_case)()
    params_np = _np_tree(jp)
    jt = JTrainer(j_loss, j_build_mesh(JMeshConfig(data=2, model=4, seq=1)),
                  j_rules, learning_rate=LR)
    js, jm = jt.train_step(jt.create_state(jp), *batch)
    ref = dict(j_flatten(_np_tree(js.params)))
    port_batch = tuple(torch.from_numpy(b).long() if b.dtype == np.int32
                       else b for b in batch)
    for step_losses, norms, params in run_ranks(
            _train_rank, 8, device="cpu", timeout=180,
            args=(kind, params_np, port_batch, 1)):
        np.testing.assert_allclose(step_losses[0], float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(norms[0], float(jm["grad_norm"]),
                                   rtol=1e-5)
        got = dict(flatten_with_paths(params))
        assert sorted(got) == sorted(ref)
        for path, leaf in got.items():
            np.testing.assert_allclose(leaf.numpy(), ref[path], rtol=0,
                                       atol=0.1 * LR, err_msg=path)
