"""The port's tensor- and sequence-parallel recognizer against the JAX
package's on the CPU: the ASR encoder at data 2 x model 4, the gradient of
``asr_loss`` at tp 2 against one device, a masked loss under data
parallelism against one device, and the sequence-parallel encoder at seq
8.

Each multi-rank case runs on gloo ranks through ``run_ranks``; the JAX
side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``. The rank functions are module-level, and every
rank imports this module to find them: JAX is imported inside the tests
only, never at the top, so that no rank loads it.

Tolerances: the sharded forward 2e-4 and the sequence-parallel encoder
3e-4 (the JAX tests' own, ``tests/test_parallel.py``); the tensor-parallel
gradients 1e-5 of each leaf's largest magnitude; the data-parallel masked
loss rtol 1e-6, its gradient norm rtol 1e-5 and the parameters after one
step 1e-5 of each leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from janus_tpu_torch.common.config import ASRConfig, MeshConfig
from janus_tpu_torch.models import asr as asr_mod
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           params_from_jax,
                                           unflatten_from_paths)
from janus_tpu_torch.parallel import collectives as C
from janus_tpu_torch.parallel.launch import run_ranks
from janus_tpu_torch.parallel.mesh import build_mesh
from janus_tpu_torch.parallel.sharding import (ASR_PARTITION_RULES,
                                               gather_params, shard_params)
from janus_tpu_torch.train import losses
from janus_tpu_torch.train.trainer import Trainer

ASR_KW = dict(n_mels=16, d_model=64, encoder_layers=2, decoder_layers=2,
              num_heads=8, vocab_size=261, max_source_positions=64,
              max_target_positions=32)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _worst(got, ref):
    """Largest |got - ref| of each leaf over that leaf's largest |ref|."""
    assert sorted(got) == sorted(ref)
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
               / max(float(np.abs(np.asarray(ref[k])).max()), 1e-30)
               for k in ref)


def _j_asr_rules():
    from janus_tpu.parallel.sharding import ASR_PARTITION_RULES as rules

    return rules

# --------------------------------------------------------------------------
# the tensor-parallel forward and its gradient
# --------------------------------------------------------------------------

def _tp_forward_rank(params_np, mel):
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    mesh = build_mesh(MeshConfig(data=2, model=4, seq=1))
    params = params_from_jax(params_np)
    local = shard_params(params, mesh, ASR_PARTITION_RULES)
    with C.use_mesh(mesh):
        out = asr_mod.encode_audio(local, cfg, torch.from_numpy(mel))
    back = gather_params(local, mesh, ASR_PARTITION_RULES)
    whole = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_paths(back), flatten_with_paths(params)))
    return out, whole


def test_sharded_asr_forward_matches_jax_and_unsharded():
    """data 2 x model 4: the port's tensor-parallel encoder against the
    JAX package's sharded one and against the port unsharded (2e-4)."""
    import jax
    import jax.numpy as jnp

    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.parallel.sharding import shard_params as j_shard

    jcfg = JASRConfig(**ASR_KW)
    jp = j_asr.init_asr(0, jcfg)
    mel = np.random.default_rng(0).standard_normal((2, 128, 16)).astype(
        np.float32)
    j_mesh = j_build_mesh(JMeshConfig(data=2, model=4, seq=1))
    j_out = np.asarray(jax.jit(lambda p, m: j_asr.encode_audio(p, jcfg, m))(
        j_shard(jp, j_mesh, _j_asr_rules()), jnp.asarray(mel)))
    params_np = _np_tree(jp)
    ref = asr_mod.encode_audio(params_from_jax(params_np),
                               ASRConfig(**ASR_KW, dtype="float32"),
                               torch.from_numpy(mel)).numpy()
    outs = run_ranks(_tp_forward_rank, 8, device="cpu",
                     args=(params_np, mel), timeout=120)
    for out, whole in outs:
        assert whole  # gather_params inverts shard_params
        np.testing.assert_allclose(out.numpy(), j_out, atol=2e-4)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def _asr_grads(params, cfg, batch):
    leaves = [t.requires_grad_() for _, t in flatten_with_paths(params)]
    loss, _ = losses.asr_loss(params, cfg, *batch)
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True)


def _tp_grad_rank(params_np, batch_np):
    """asr_loss's gradient at tp = 2, gathered, and at tp = 1 on the whole
    tree, on every rank."""
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    batch = tuple(torch.from_numpy(b) for b in batch_np)
    mesh = build_mesh(MeshConfig(data=1, model=2, seq=1))
    local = shard_params(params_from_jax(params_np), mesh,
                         ASR_PARTITION_RULES)
    with C.use_mesh(mesh):
        loss_tp, grads = _asr_grads(local, cfg, batch)
    paths = [p for p, _ in flatten_with_paths(local)]
    grads = {p: torch.zeros_like(t) if g is None else g.detach()
             for (p, t), g in zip(flatten_with_paths(local), grads)}
    grads_tp = dict(flatten_with_paths(gather_params(
        unflatten_from_paths(grads), mesh, ASR_PARTITION_RULES)))
    loss_1, grads_1 = _asr_grads(params_from_jax(params_np), cfg, batch)
    grads_1 = {p: torch.zeros_like(grads_tp[p]) if g is None else g
               for p, g in zip(paths, grads_1)}
    return (float(loss_tp), float(loss_1),
            _worst({k: v.numpy() for k, v in grads_tp.items()},
                   {k: v.numpy() for k, v in grads_1.items()}))


def test_tensor_parallel_gradient_equals_one_device():
    """Megatron's pair: the entry of a column-parallel region all-reduces
    the gradient, the exit of a row-parallel one passes it through. A
    gradient counted tp times (``all_reduce`` differentiated both ways)
    would fail by a factor of 2."""
    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.models import asr as j_asr

    params_np = _np_tree(j_asr.init_asr(0, JASRConfig(**ASR_KW)))
    rng = np.random.default_rng(3)
    batch = (rng.standard_normal((2, 128, 16)).astype(np.float32),
             rng.integers(0, 260, size=(2, 12)).astype(np.int64),
             (rng.random((2, 12)) < 0.8).astype(np.float32))
    for loss_tp, loss_1, worst in run_ranks(_tp_grad_rank, 2, device="cpu",
                                            args=(params_np, batch),
                                            timeout=120):
        np.testing.assert_allclose(loss_tp, loss_1, rtol=1e-6)
        assert worst <= 1e-5, worst


def _dp_loss_rank(params_np, batch_np):
    """One Trainer step at data = 2 on the global batch."""
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    mesh = build_mesh(MeshConfig(data=2, model=1, seq=1))
    tr = Trainer(lambda p, *b: losses.asr_loss(p, cfg, *b),
                 learning_rate=1e-3, mesh=mesh, rules=ASR_PARTITION_RULES)
    state, m = tr.train_step(tr.create_state(params_from_jax(params_np)),
                             *batch_np)
    return float(m["loss"]), float(m["grad_norm"]), state.params


def test_masked_loss_under_data_parallel_equals_one_device():
    """The two data ranks hold 2 and 11 loss-bearing tokens: the mean of
    per-rank means would be another number. The loss, the gradient norm
    and the parameters after one step equal the one-device trainer's."""
    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.models import asr as j_asr

    params_np = _np_tree(j_asr.init_asr(0, JASRConfig(**ASR_KW)))
    rng = np.random.default_rng(4)
    mask = np.zeros((4, 12), np.float32)
    mask[0, :2] = 1
    mask[2:, :7] = 1
    batch = (rng.standard_normal((4, 128, 16)).astype(np.float32),
             rng.integers(0, 260, size=(4, 12)).astype(np.int64), mask)
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    tr = Trainer(lambda p, *b: losses.asr_loss(p, cfg, *b),
                 learning_rate=1e-3)
    state, m = tr.train_step(tr.create_state(params_from_jax(params_np)),
                             *batch)
    ref = {k: v.numpy() for k, v in flatten_with_paths(state.params)}
    for loss, norm, params in run_ranks(_dp_loss_rank, 2, device="cpu",
                                        args=(params_np, batch),
                                        timeout=120):
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-6)
        np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=1e-5)
        got = {k: v.numpy() for k, v in flatten_with_paths(params)}
        assert _worst(got, ref) <= 1e-5



def _sp_encoder_rank(params_np, mel):
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    mesh = build_mesh(MeshConfig(data=1, model=1, seq=8))
    return asr_mod.encode_audio(params_from_jax(params_np), cfg,
                                torch.from_numpy(mel), sp_mesh=mesh)


def test_sequence_parallel_encoder_matches_jax_and_dense():
    """seq 8: frames split over the ranks (conv stem from each rank's
    frames and halo, positions at global offsets), ring attention in each
    layer, the output all-gathered: against the JAX package's
    sequence-parallel encoder and the dense one (3e-4)."""
    import jax
    import jax.numpy as jnp

    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh

    jcfg = JASRConfig(**ASR_KW)
    jp = j_asr.init_asr(0, jcfg)
    mel = np.random.default_rng(5).standard_normal((2, 128, 16)).astype(
        np.float32)
    j_mesh = j_build_mesh(JMeshConfig(data=1, model=1, seq=8))
    j_out = np.asarray(jax.jit(lambda m: j_asr.encode_audio(
        jp, jcfg, m, sp_mesh=j_mesh))(jnp.asarray(mel)))
    dense = np.asarray(j_asr.encode_audio(jp, jcfg, jnp.asarray(mel)))
    for out in run_ranks(_sp_encoder_rank, 8, device="cpu",
                         args=(_np_tree(jp), mel), timeout=120):
        np.testing.assert_allclose(out.numpy(), j_out, atol=3e-4)
        np.testing.assert_allclose(out.numpy(), dense, atol=3e-4)


def test_sequence_parallel_encoder_needs_frames_that_split():
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(1, 1, 8),
                      mesh_dim_names=("data", "model", "seq"),
                      _init_backend=False, _rank=0)
    cfg = ASRConfig(**ASR_KW, dtype="float32")
    with pytest.raises(ValueError, match="do not split"):
        asr_mod.encode_audio({"encoder": {}}, cfg, torch.zeros(1, 20, 16),
                             sp_mesh=mesh)


def _unaware_loss_rank():
    """A loss that takes a plain mean of its own shard under data = 2."""
    mesh = build_mesh(MeshConfig(data=2, model=1, seq=1))
    tr = Trainer(lambda p, x: ((p["w"] * x).mean(), {}), mesh=mesh,
                 rules=ASR_PARTITION_RULES)
    tr.train_step(tr.create_state({"w": torch.ones(3)}), np.ones((4, 3),
                                                                 np.float32))


def test_trainer_refuses_a_loss_that_ignores_the_global_batch():
    """Under data parallelism each rank's gradient must be its share of
    the global loss's; a loss that never called dp_sum / dp_mean would be
    summed over the ranks as if it were, so the step is refused."""
    with pytest.raises(RuntimeError, match="must reduce over the batch"):
        run_ranks(_unaware_loss_rank, 2, device="cpu", timeout=120)


def test_trainer_mesh_arguments_are_checked():
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1, 1),
                      mesh_dim_names=("data", "model", "seq"),
                      _init_backend=False, _rank=1)
    with pytest.raises(ValueError, match="partition rules"):
        Trainer(lambda p: p, mesh=mesh)
    tr = Trainer(lambda p: p, mesh=mesh, rules=ASR_PARTITION_RULES)
    x = np.arange(8).reshape(4, 2)
    got, scalar = tr.shard_batch(x, np.float32(3))
    np.testing.assert_array_equal(got, x[2:])  # rank 1's half
    assert scalar == 3
    with pytest.raises(ValueError, match="does not split"):
        tr.shard_batch(np.zeros((3, 2)))


def _model_shard(tree, rules, tp=2):
    """Rank 0's shard of ``tree`` at ``model`` = ``tp``, cut by hand."""
    from janus_tpu_torch.parallel.sharding import partition_spec_for

    out = {}
    for path, leaf in flatten_with_paths(tree):
        spec = partition_spec_for(path, rules)
        if "model" in spec and len(spec) <= leaf.ndim:
            dim = spec.index("model")
            leaf = leaf.narrow(dim, 0, leaf.shape[dim] // tp)
        out[path] = leaf
    return unflatten_from_paths(out)


def _tp_cases():
    from janus_tpu_torch.common.config import TTSConfig, VocoderConfig
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.models.params import init_asr
    from janus_tpu_torch.parallel.sharding import (TTS_PARTITION_RULES,
                                                   VOCODER_PARTITION_RULES)

    g = torch.Generator().manual_seed(0)
    acfg = ASRConfig(**ASR_KW, dtype="float32")
    tcfg = TTSConfig(d_model=64, layers=2, num_heads=4, n_mels=16,
                     reduction=2, max_text_tokens=32, max_mel_frames=32)
    vcfg = VocoderConfig(d_model=64, layers=2, n_fft=256, hop_length=64)
    asr_p = init_asr(g, acfg)
    tts_p = tts_mod.init_tts(g, tcfg, text_vocab=261)
    voc_p = voc_mod.init_vocoder(g, vcfg, n_mels=16)
    enc = torch.zeros(1, 8, 64)
    return {
        "asr_encoder": (ASR_PARTITION_RULES, asr_p, lambda p: (
            asr_mod.encode_audio(p, acfg, torch.zeros(1, 16, 16)))),
        "asr_decoder": (ASR_PARTITION_RULES, asr_p, lambda p: (
            asr_mod.init_decode_state(p, acfg, enc, max_len=8))),
        "tts": (TTS_PARTITION_RULES, tts_p, lambda p: tts_mod.tts_forward(
            p, tcfg, torch.zeros(1, 8, dtype=torch.long),
            torch.zeros(1, dtype=torch.long), torch.zeros(1, 4, 32))),
        "vocoder": (VOCODER_PARTITION_RULES, voc_p, lambda p: (
            voc_mod.vocoder_spectra(p, vcfg, torch.zeros(1, 8, 16)))),
    }


@pytest.mark.parametrize("model", ["asr_encoder", "asr_decoder", "tts",
                                   "vocoder"])
@pytest.mark.parametrize("where", ["shard_without_mesh",
                                   "whole_tree_under_mesh"])
def test_a_tree_run_outside_its_tensor_parallel_degree_raises(model, where):
    """A tree sharded over ``model`` = 2 and run with no mesh, or a whole
    tree run under a ``model`` = 2 mesh, raises: it would otherwise split
    its heads wrong and skip (or add) the row-parallel all-reduce."""
    rules, params, run = _tp_cases()[model]
    run(params)  # the whole tree with no mesh runs
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2, 1),
                      mesh_dim_names=("data", "model", "seq"),
                      _init_backend=False, _rank=0)
    with pytest.raises(ValueError, match="another tensor-parallel degree"):
        if where == "shard_without_mesh":
            run(_model_shard(params, rules))
        else:
            with C.use_mesh(mesh):
                run(params)
