"""The port's training path against the JAX package on the CPU at small
sizes: the four losses and their gradients (``jax.value_and_grad`` on the
same carried-across parameters and batch), the optimizer against optax on
identical gradients, three ASR training steps in both packages, the
checkpoint round trip, and a port-written npz read by the JAX package.

Tolerances: losses rtol 1e-5 and each gradient leaf within 1e-4 of its
largest magnitude; the optimizer rtol 1e-6; three training steps rtol
1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from janus_tpu.common.config import ASRConfig as JASRConfig
from janus_tpu.common.config import MeshConfig
from janus_tpu.common.config import TTSConfig as JTTSConfig
from janus_tpu.common.config import VocoderConfig as JVocoderConfig
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.models import asr as j_asr
from janus_tpu.models import tts as j_tts
from janus_tpu.models import vad as j_vad
from janus_tpu.models import vocoder as j_voc
from janus_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from janus_tpu.parallel.mesh import build_mesh
from janus_tpu.parallel.sharding import ASR_PARTITION_RULES
from janus_tpu.train import losses as j_losses
from janus_tpu.train.trainer import Trainer as JTrainer
from janus_tpu_torch.common.config import ASRConfig, TTSConfig, VocoderConfig
from janus_tpu_torch.models.asr import prepare_mel
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           load_npz_params, map_tree,
                                           params_from_jax,
                                           params_to_jax, save_npz)
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.layers import linear
from janus_tpu_torch.train import checkpoint, losses
from janus_tpu_torch.train.demo import train_demo_asr
from janus_tpu_torch.train.synthetic_task import sample_batch
from janus_tpu_torch.train.trainer import (Trainer,
                                           warmup_cosine_decay_schedule)

ASR_KW = dict(n_mels=16, d_model=64, encoder_layers=2, decoder_layers=2,
              num_heads=2, vocab_size=261, max_source_positions=16,
              max_target_positions=12, max_decode_tokens=8, dtype="float32")
TTS_KW = dict(d_model=32, layers=2, num_heads=2, n_mels=8, reduction=2,
              max_text_tokens=8, max_mel_frames=16)
VOC_KW = dict(d_model=32, layers=2, n_fft=64, hop_length=16,
              sample_rate=16_000)


def _asr_batch(seed=0, batch=3):
    tok = ByteTokenizer()
    cfg = ASRConfig(**ASR_KW)
    audio, tokens, mask, _ = sample_batch(
        np.random.default_rng(seed), batch, tok,
        max_seconds=2 * cfg.max_source_positions * cfg.hop_length / 16_000,
        max_tokens=cfg.max_target_positions, min_words=1, max_words=1)
    return audio, tokens, mask


def _asr_case():
    jcfg, tcfg = JASRConfig(**ASR_KW), ASRConfig(**ASR_KW)
    jp = j_asr.init_asr(0, jcfg)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 2 * jcfg.max_source_positions,
                               jcfg.n_mels)).astype(np.float32)
    _, tokens, mask = _asr_batch(batch=2)
    return (jp, lambda p, *b: j_losses.asr_loss(p, jcfg, *b),
            lambda p, *b: losses.asr_loss(p, tcfg, *b), (mel, tokens, mask))


def _tts_case():
    jcfg, tcfg = JTTSConfig(**TTS_KW), TTSConfig(**TTS_KW)
    jp = j_tts.init_tts(0, jcfg, text_vocab=261)
    rng = np.random.default_rng(2)
    text = rng.integers(0, 256, (2, 6)).astype(np.int32)
    emo = rng.integers(0, 12, (2,)).astype(np.int32)
    groups = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    spk = rng.standard_normal((2, 32)).astype(np.float32)
    noisy = (groups + 0.3 * rng.standard_normal(groups.shape)
             ).astype(np.float32)
    return (jp,
            lambda p, *b: j_losses.tts_loss(p, jcfg, *b[:4], speaker=b[4],
                                            mel_inputs=b[5]),
            lambda p, *b: losses.tts_loss(p, tcfg, *b[:4], speaker=b[4],
                                          mel_inputs=b[5]),
            (text, emo, groups, mask, spk, noisy))


def _vocoder_case():
    jcfg, tcfg = JVocoderConfig(**VOC_KW), VocoderConfig(**VOC_KW)
    jp = j_voc.init_vocoder(0, jcfg, n_mels=8)
    rng = np.random.default_rng(3)
    frames = 48
    mel = rng.standard_normal((2, frames, 8)).astype(np.float32)
    wav = (0.1 * rng.standard_normal((2, frames * 16))).astype(np.float32)
    return (jp, lambda p, *b: j_losses.vocoder_loss(p, jcfg, *b),
            lambda p, *b: losses.vocoder_loss(p, tcfg, *b), (mel, wav))


def _vad_case():
    jp = j_vad.init_vad(0)
    rng = np.random.default_rng(4)
    chunk = (0.1 * rng.standard_normal((6, 512))).astype(np.float32)
    label = np.array([0, 1, 1, 0, 1, 0], np.float32)
    return (jp, j_losses.vad_loss, losses.vad_loss, (chunk, label))


CASES = {"asr": _asr_case, "tts": _tts_case, "vad": _vad_case}


def _jax_value_and_grad(j_fn, jp, batch):
    (loss, aux), grads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jp, *(jnp.asarray(b) for b in batch))
    return loss, aux, dict(flatten_with_paths(jax.device_get(grads)))


def _port_value_and_grad(t_fn, tp, batch):
    pairs = list(flatten_with_paths(tp))
    leaves = [v.requires_grad_() for _, v in pairs]
    loss, aux = t_fn(tp, *(torch.from_numpy(b) for b in batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, {k: (torch.zeros_like(v) if g is None else g
                                    ).numpy() for (k, v), g in zip(pairs,
                                                                   grads)}


def _worst(got, ref):
    """Largest |got - ref| of each leaf over that leaf's largest |ref|."""
    assert sorted(got) == sorted(ref)
    return max(float(np.abs(got[k] - ref[k]).max())
               / max(float(np.abs(ref[k]).max()), 1e-30) for k in ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_jax(name):
    jp, j_fn, t_fn, batch = CASES[name]()
    j_loss, j_aux, j_grads = _jax_value_and_grad(j_fn, jp, batch)
    t_loss, t_aux, t_grads = _port_value_and_grad(t_fn, params_from_jax(jp),
                                                  batch)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for key in j_aux:
        np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert _worst(t_grads, j_grads) <= 1e-4


def test_vocoder_loss_and_gradients_match_jax():
    """The loss in float32 at rtol 1e-5. Its gradient is ill-conditioned
    in float32: the log-magnitude term weighs each STFT bin by
    1/(|X| + 1e-5), so FFT rounding moves it; the JAX package's own
    float32 gradient lies ~2e-4 (of each leaf's largest magnitude) from
    its float64 evaluation. So the gradients are held at 1e-4 in float64
    (both packages, same parameters and batch), and the port's float32
    gradient must lie no farther from that float64 reference than twice
    the JAX package's float32 one."""
    jp, j_fn, t_fn, batch = _vocoder_case()
    j_loss, j_aux, j_grads = _jax_value_and_grad(j_fn, jp, batch)
    t_loss, t_aux, t_grads = _port_value_and_grad(t_fn, params_from_jax(jp),
                                                  batch)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for key in j_aux:
        np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]),
                                   rtol=1e-5, err_msg=key)

    batch64 = tuple(b.astype(np.float64) for b in batch)
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
        j_loss64, _, j_grads64 = _jax_value_and_grad(j_fn, jp64, batch64)
    t_loss64, _, t_grads64 = _port_value_and_grad(
        t_fn, map_tree(torch.Tensor.double, params_from_jax(jp)), batch64)
    np.testing.assert_allclose(float(t_loss64), float(j_loss64), rtol=1e-8)
    assert _worst(t_grads64, j_grads64) <= 1e-4
    assert _worst(t_grads, j_grads64) <= 2 * _worst(j_grads, j_grads64)


def test_mixed_dtype_linear_is_differentiable():
    """A bf16 weight under fp32 activations (the receive side's mixed
    branch of ``linear``): gradients reach both, equal to those of the
    promoted product."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.zeros(6, dtype=torch.bfloat16)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y = linear(xs, ws, bs)
    assert y.dtype == torch.float32
    y.square().sum().backward()
    xr, wr, br = (t.clone().float().requires_grad_() for t in (x, w, b))
    (xr @ wr + br).square().sum().backward()
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ws.grad.float(), wr.grad.to(
        torch.bfloat16).float(), rtol=0, atol=0)
    assert bs.grad.dtype == torch.bfloat16


def test_optimizer_matches_optax_on_identical_gradients():
    """clip_by_global_norm(1) + adamw(warmup-cosine, wd 0.01) over three
    steps whose gradients are fixed arrays with global norms above the
    clip: the loss ``sum(p * G_k)`` has gradient ``G_k`` exactly. The
    parameters and both moments within 1e-6 of each leaf's largest
    magnitude after every step."""
    rng = np.random.default_rng(6)
    shapes = {"a": {"w": (5, 4), "b": (4,)}, "c": [(3,), (2, 2)]}
    init = {"a": {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes["a"].items()},
            "c": [rng.standard_normal(s).astype(np.float32)
                  for s in shapes["c"]]}
    grads = [jax.tree.map(lambda p: (3.0 * rng.standard_normal(p.shape))
                          .astype(np.float32), init) for _ in range(3)]
    sched_kw = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                    decay_steps=10, end_value=1e-4)
    j_sched = optax.warmup_cosine_decay_schedule(**sched_kw)
    t_sched = warmup_cosine_decay_schedule(**sched_kw)
    for count in range(0, 14):
        np.testing.assert_allclose(t_sched(count), float(j_sched(count)),
                                   rtol=1e-6)

    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(j_sched, weight_decay=0.01))
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = opt.init(jparams)

    box = {}

    def loss_fn(p, k):
        g = dict(flatten_with_paths(box["g"]))
        total = sum((leaf * torch.from_numpy(np.asarray(g[path]))).sum()
                    for path, leaf in flatten_with_paths(p))
        return total, {}

    trainer = Trainer(loss_fn, learning_rate=t_sched)
    state = trainer.create_state(params_from_jax(init))
    for k, g in enumerate(grads):
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        box["g"] = g
        state, metrics = trainer.train_step(state, k)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(optax.global_norm(g)), rtol=1e-6)
        assert float(metrics["grad_norm"]) > 1.0  # the clip is active
        # rtol 1e-6 of each leaf's largest magnitude: an element the step
        # carries near zero keeps the absolute rounding of its operands
        ref = dict(flatten_with_paths(jax.device_get(jparams)))
        got = dict(flatten_with_paths(params_to_jax(state.params)))
        assert _worst(got, ref) <= 1e-6, k
        for name in ("mu", "nu"):
            moment = getattr(jstate[1][0], name)
            assert _worst(dict(flatten_with_paths(params_to_jax(
                state.opt_state[name]))), dict(flatten_with_paths(
                    jax.device_get(moment)))) <= 1e-6, (k, name)
    assert state.opt_state["count"] == 3 and state.step == 3


def test_three_asr_steps_match_jax():
    """Three steps of each package's trainer on one batch from the same
    weights, the log-mel computed inside the step as ``train_demo_asr``
    does: losses rtol 1e-4."""
    jcfg, tcfg = JASRConfig(**ASR_KW), ASRConfig(**ASR_KW)
    n_frames = 2 * jcfg.max_source_positions
    jp = j_asr.init_asr(0, jcfg)
    audio, tokens, mask = _asr_batch(seed=7, batch=3)

    def j_loss(p, a, t, m):
        return j_losses.asr_loss(p, jcfg, j_asr.prepare_mel(
            a, jcfg, pad_to_frames=n_frames), t, m)

    def t_loss(p, a, t, m):
        return losses.asr_loss(p, tcfg, prepare_mel(
            a, tcfg, pad_to_frames=n_frames), t, m)

    jt = JTrainer(j_loss, build_mesh(MeshConfig(data=1, model=1, seq=1)),
                  ASR_PARTITION_RULES, learning_rate=1e-3)
    tt = Trainer(t_loss, learning_rate=1e-3)
    js, ts = jt.create_state(jp), tt.create_state(params_from_jax(jp))
    for _ in range(3):
        js, jm = jt.train_step(js, audio, tokens, mask)
        ts, tm = tt.train_step(ts, audio, tokens, mask)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


def test_checkpoint_round_trip(tmp_path):
    jp = j_vad.init_vad(0)

    def loss_fn(p, chunk, label):
        return losses.vad_loss(p, chunk, label)

    rng = np.random.default_rng(8)
    chunk = (0.1 * rng.standard_normal((4, 512))).astype(np.float32)
    label = np.array([0, 1, 1, 0], np.float32)
    trainer = Trainer(loss_fn)
    state = trainer.create_state(params_from_jax(jp))
    state, _ = trainer.train_step(state, chunk, label)
    checkpoint.save_train_state(str(tmp_path / "ts"), state)
    back = checkpoint.load_train_state(str(tmp_path / "ts"))
    assert back.step == 1 and back.opt_state["count"] == 1
    for a, b in ((state.params, back.params),
                 (state.opt_state["mu"], back.opt_state["mu"]),
                 (state.opt_state["nu"], back.opt_state["nu"])):
        for (ka, va), (kb, vb) in zip(flatten_with_paths(a),
                                      flatten_with_paths(b)):
            assert ka == kb and torch.equal(va, vb)
    # training continues from the restored state exactly as from the live one
    s1, m1 = trainer.train_step(state, chunk, label)
    s2, m2 = trainer.train_step(back, chunk, label)
    assert float(m1["loss"]) == float(m2["loss"])
    checkpoint.save_params(str(tmp_path / "p"), s1.params)
    for (_, va), (_, vb) in zip(
            flatten_with_paths(checkpoint.load_params(str(tmp_path / "p"))),
            flatten_with_paths(s2.params)):
        assert torch.equal(va, vb)


def test_train_demo_asr_writes_an_npz_the_jax_package_loads(tmp_path):
    """``train_demo_asr`` through its entry point on the CPU; its npz
    loads in both packages to the same fp16-rounded tree, and the JAX
    recognizer runs on it."""
    params, cfg, tok, history = train_demo_asr(
        steps=3, batch=2, cfg=ASRConfig(**ASR_KW), pool_n=4, log_every=0,
        max_seconds=1.0, device="cpu")
    assert len(history) == 3 and all(np.isfinite(history))
    path = str(tmp_path / "asr.npz")
    save_npz(path, params)
    mine = params_to_jax(load_npz_params(path))
    theirs = jax.device_get(j_load_npz(path))
    flat_t, flat_j = dict(flatten_with_paths(mine)), dict(
        flatten_with_paths(theirs))
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flatten_with_paths(params_to_jax(params)):
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
        np.testing.assert_array_equal(flat_t[k],
                                      v.astype(np.float16).astype(np.float32))
    jcfg = dataclasses.replace(JASRConfig(**ASR_KW))
    mel = j_asr.prepare_mel(jnp.zeros((1, 5120)), jcfg, pad_to_frames=32)
    out = j_asr.transcribe_mel(theirs, jcfg, mel,
                               jnp.full((1, 1), JByteTokenizer().sot,
                                        jnp.int32), JByteTokenizer().eot)
    assert out.shape == (1, jcfg.max_decode_tokens)
