"""The port's parallel layouts against the JAX package's on the CPU: the
mesh, the partition rules and the local shards, ring and Ulysses
attention, the pipeline schedule, the hybrid mesh and the launcher's
failure handling (the tensor- and sequence-parallel recognizer is in
``tests/test_torch_parallel_model.py``).

Each multi-rank case runs on gloo ranks through ``run_ranks``; the JAX
side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``. The rank functions are module-level, and every
rank imports this module to find them: JAX is imported inside the tests
only, never at the top, so that no rank loads it.

Tolerances are the JAX tests' own (``tests/test_parallel.py``,
``tests/test_pipeline.py``): ring and Ulysses 2e-5, linear pipeline
stages 1e-5, the encoder stage split 2e-4.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from janus_tpu_torch.common.config import MeshConfig
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           params_from_jax)
from janus_tpu_torch.ops.attention import attend, causal_mask
from janus_tpu_torch.parallel import collectives as C
from janus_tpu_torch.parallel.distributed import (HYBRID_AXES,
                                                  build_hybrid_mesh, dp_spec,
                                                  initialize_from_env,
                                                  num_slices)
from janus_tpu_torch.parallel.launch import run_ranks, stop_rank_server
from janus_tpu_torch.parallel.mesh import best_mesh_shape, build_mesh
from janus_tpu_torch.parallel.pipeline import (pipeline_apply,
                                               split_encoder_stages,
                                               stack_stage_params)
from janus_tpu_torch.parallel.ring_attention import ring_attention
from janus_tpu_torch.parallel.sharding import (ASR_PARTITION_RULES,
                                               TTS_PARTITION_RULES,
                                               VOCODER_PARTITION_RULES,
                                               partition_spec_for,
                                               shard_params)
from janus_tpu_torch.parallel.ulysses import ulysses_attention

ASR_KW = dict(n_mels=16, d_model=64, encoder_layers=2, decoder_layers=2,
              num_heads=8, vocab_size=261, max_source_positions=64,
              max_target_positions=32)


def _fake_mesh(shape, names, rank):
    """The mesh as rank ``rank`` sees it, without a process group: enough
    for the code that reads only coordinates (no collective is issued)."""
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=rank)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _worst(got, ref):
    """Largest |got - ref| of each leaf over that leaf's largest |ref|."""
    assert sorted(got) == sorted(ref)
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
               / max(float(np.abs(np.asarray(ref[k])).max()), 1e-30)
               for k in ref)


# --------------------------------------------------------------------------
# the mesh and the rules
# --------------------------------------------------------------------------

def test_mesh_shapes():
    assert best_mesh_shape(8, model=2, seq=2) == (2, 2, 2)
    assert best_mesh_shape(8) == (8, 1, 1)
    with pytest.raises(ValueError):
        best_mesh_shape(8, model=3)
    # one rank and no process group: the (1, 1, 1) mesh needs none
    mesh = build_mesh(MeshConfig())
    assert C.mesh_shape(mesh) == {"data": 1, "model": 1, "seq": 1}
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 1"):
        build_mesh(MeshConfig(data=2, model=2, seq=2))


def _mesh_rank():
    mesh = build_mesh(MeshConfig(data=2, model=2, seq=2))
    return C.mesh_shape(mesh), [C.axis_index(mesh, n)
                                for n in ("data", "model", "seq")]


def test_mesh_on_eight_ranks_is_laid_out_row_major():
    out = run_ranks(_mesh_rank, 8, device="cpu", timeout=120)
    for rank, (shape, coord) in enumerate(out):
        assert shape == {"data": 2, "model": 2, "seq": 2}
        assert coord == [rank // 4, rank // 2 % 2, rank % 2]


@pytest.mark.parametrize("path,rules,spec", [
    ("encoder/blocks/0/attn/q/w", ASR_PARTITION_RULES, (None, "model")),
    ("decoder/blocks/3/cross/out/w", ASR_PARTITION_RULES, ("model", None)),
    ("encoder/blocks/0/mlp/fc1/b", ASR_PARTITION_RULES, ("model",)),
    ("decoder/blocks/1/cross/out/b", ASR_PARTITION_RULES, ()),
    ("decoder/token_emb", ASR_PARTITION_RULES, ()),
    ("blocks/0/mlp/fc1/w", TTS_PARTITION_RULES, (None, "model")),
    ("blocks/0/attn/out/b", TTS_PARTITION_RULES, ()),
    ("blocks/1/pw2/w", VOCODER_PARTITION_RULES, ("model", None)),
    # the head rules need a segment before the head's name: the top-level
    # heads stay whole, as in the JAX package
    ("mag_head/w", VOCODER_PARTITION_RULES, ()),
])
def test_partition_rules_hit_expected_paths(path, rules, spec):
    from jax.sharding import PartitionSpec as P

    from janus_tpu.parallel import sharding as j_sharding

    assert partition_spec_for(path, rules) == spec
    j_rules = {id(ASR_PARTITION_RULES): j_sharding.ASR_PARTITION_RULES,
               id(TTS_PARTITION_RULES): j_sharding.TTS_PARTITION_RULES,
               id(VOCODER_PARTITION_RULES):
               j_sharding.VOCODER_PARTITION_RULES}[id(rules)]
    assert j_sharding.partition_spec_for(path, j_rules) == P(*spec)


def test_local_shards_equal_jax_addressable_shards():
    """Every rank's shard of every leaf equals the shard JAX places on the
    device at the same mesh coordinate."""
    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.models.params import flatten_with_paths as j_flatten
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.parallel.sharding import shard_params as j_shard

    jp = j_asr.init_asr(0, JASRConfig(**ASR_KW))
    j_mesh = j_build_mesh(JMeshConfig(data=2, model=2, seq=2))
    j_flat = dict(j_flatten(j_shard(jp, j_mesh, _j_asr_rules())))
    devices = list(j_mesh.devices.flat)
    params = params_from_jax(_np_tree(jp))
    for rank in range(8):
        mesh = _fake_mesh((2, 2, 2), ("data", "model", "seq"), rank)
        local = dict(flatten_with_paths(shard_params(params, mesh,
                                                     ASR_PARTITION_RULES)))
        for path, leaf in j_flat.items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(local[path].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{path} rank {rank}")


def _j_asr_rules():
    from janus_tpu.parallel.sharding import ASR_PARTITION_RULES as rules

    return rules


def test_shard_params_raises_on_uneven_split():
    mesh = _fake_mesh((1, 2, 1), ("data", "model", "seq"), 0)
    tree = {"blocks": [{"attn": {"q": {"w": torch.zeros(4, 5)}}}]}
    with pytest.raises(ValueError, match="not divisible"):
        shard_params(tree, mesh, ASR_PARTITION_RULES)
    assert shard_params({"blocks": [{"attn": {"q": {"w": torch.zeros(
        4, 6)}}}]}, mesh, ASR_PARTITION_RULES)["blocks"][0]["attn"]["q"][
            "w"].shape == (4, 3)


# --------------------------------------------------------------------------
# ring and Ulysses attention, the sequence-parallel encoder
# --------------------------------------------------------------------------

def _seq_attention_rank(kind, q, k, v, causal):
    mesh = build_mesh(MeshConfig(data=1, model=1, seq=8))
    i, blk = C.axis_index(mesh, "seq"), q.shape[2] // 8
    part = [torch.from_numpy(a[:, :, i * blk:(i + 1) * blk])
            for a in (q, k, v)]
    fn = ring_attention if kind == "ring" else ulysses_attention
    return C.all_gather(fn(*part, mesh, causal=causal), mesh, "seq", dim=2)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_attention_matches_jax(kind, causal):
    """seq 8: each rank's block of the port's ring (Ulysses) attention,
    gathered, against the JAX package's over the same global arrays and
    against plain attention (2e-5)."""
    import jax
    import jax.numpy as jnp

    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.parallel.ring_attention import ring_attention as j_ring
    from janus_tpu.parallel.ulysses import ulysses_attention as j_ulysses

    rng = np.random.default_rng(1 if kind == "ring" else 2)
    heads = 4 if kind == "ring" else 8
    q, k, v = (rng.standard_normal((2, heads, 64, 16)).astype(np.float32)
               for _ in range(3))
    j_fn = functools.partial(
        j_ring if kind == "ring" else j_ulysses,
        mesh=j_build_mesh(JMeshConfig(data=1, model=1, seq=8)),
        causal=causal)
    # jitted: the eager shard_map dispatches every step on its own (~15 s)
    j_out = np.asarray(jax.jit(j_fn)(*(jnp.asarray(a) for a in (q, k, v))))
    ref = attend(*(torch.from_numpy(a) for a in (q, k, v)),
                 causal_mask(64, 64) if causal else None).numpy()
    for out in run_ranks(_seq_attention_rank, 8, device="cpu",
                         args=(kind, q, k, v, causal), timeout=120):
        np.testing.assert_allclose(out.numpy(), j_out, atol=2e-5)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_ulysses_head_divisibility():
    mesh = _fake_mesh((1, 1, 8), ("data", "model", "seq"), 0)
    q = torch.zeros((1, 6, 8, 8))
    with pytest.raises(ValueError, match="heads=6 not divisible"):
        ulysses_attention(q, q, q, mesh)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"])


def _pipeline_rank(n_stages, params_np, x, num_heads):
    """The port's own split and stacking: ``params_np`` is the list of
    stage weights (linear stages) or the ASR tree (encoder stages)."""
    mesh = build_mesh(MeshConfig(data=1, model=1, seq=n_stages,
                                 axis_names=("a", "b", "stage")))
    if num_heads is None:
        stage_params = [{"w": torch.from_numpy(w)} for w in params_np]
        fn = _tanh_stage
    else:
        stage_params, stage_fn = split_encoder_stages(
            params_from_jax(params_np), n_stages)
        fn = functools.partial(stage_fn, num_heads=num_heads)
    return pipeline_apply(fn, stack_stage_params(stage_params),
                          torch.from_numpy(x), mesh, axis_name="stage")


@pytest.mark.parametrize("kind", ["linear", "encoder"])
def test_pipeline_matches_jax_and_sequential(kind):
    """8 linear stages (1e-5), and the ASR encoder's 4 blocks split into 4
    stages (2e-4): the GPipe schedule against the stages applied in order
    and against the JAX package's ``pipeline_apply``."""
    import jax
    import jax.numpy as jnp

    from janus_tpu.common.config import ASRConfig as JASRConfig
    from janus_tpu.common.config import MeshConfig as JMeshConfig
    from janus_tpu.models import asr as j_asr
    from janus_tpu.parallel.mesh import build_mesh as j_build_mesh
    from janus_tpu.parallel.pipeline import pipeline_apply as j_pipeline
    from janus_tpu.parallel.pipeline import split_encoder_stages as j_split
    from janus_tpu.parallel.pipeline import stack_stage_params as j_stack

    if kind == "linear":
        rng = np.random.default_rng(0)
        ws = [rng.standard_normal((16, 16)).astype(np.float32) * 0.2
              for _ in range(8)]
        stage_params = [{"w": jnp.asarray(w)} for w in ws]
        x = rng.standard_normal((16, 16)).astype(np.float32)
        ref = x
        for w in ws:
            ref = np.tanh(ref @ w)

        def j_fn(p, h):
            return jnp.tanh(h @ p["w"])
        n_stages, atol, num_heads, port_params = 8, 1e-5, None, ws
    else:
        jcfg = JASRConfig(n_mels=16, d_model=64, encoder_layers=4,
                          decoder_layers=1, num_heads=4, vocab_size=261,
                          max_source_positions=32, max_target_positions=16)
        jp = j_asr.init_asr(0, jcfg)
        stage_params, j_stage = j_split(jp, 4)
        x = np.random.default_rng(1).standard_normal((8, 32, 64)).astype(
            np.float32)
        ref = np.asarray(jax.jit(lambda h: functools.reduce(
            lambda a, sp: j_stage(sp, a, jcfg.num_heads), stage_params,
            h))(jnp.asarray(x)))

        def j_fn(p, h):
            return j_stage(p, h, jcfg.num_heads)
        n_stages, atol, num_heads = 4, 2e-4, jcfg.num_heads
        port_params = _np_tree(jp)
    stacked = j_stack(stage_params)
    j_mesh = j_build_mesh(JMeshConfig(data=1, model=1, seq=n_stages,
                                      axis_names=("a", "b", "stage")))
    j_out = np.asarray(jax.jit(lambda st, h: j_pipeline(
        j_fn, st, h, j_mesh, axis_name="stage"))(stacked, jnp.asarray(x)))
    for out in run_ranks(_pipeline_rank, n_stages, device="cpu",
                         args=(n_stages, port_params, x, num_heads),
                         timeout=120):
        np.testing.assert_allclose(out.numpy(), ref, atol=atol)
        np.testing.assert_allclose(out.numpy(), j_out, atol=atol)


def test_pipeline_validation():
    mesh = _fake_mesh((1, 1, 8), ("a", "b", "stage"), 0)
    stacked = stack_stage_params([{"w": torch.eye(4)} for _ in range(8)])
    with pytest.raises(ValueError, match="not divisible by 8 microbatches"):
        pipeline_apply(lambda p, x: x, stacked, torch.zeros((10, 4)), mesh,
                       axis_name="stage")
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        split_encoder_stages({"encoder": {"blocks": [{}] * 6}}, 4)


# --------------------------------------------------------------------------
# multi-host bootstrap, hybrid mesh, the launcher
# --------------------------------------------------------------------------

def test_initialize_noop_without_env():
    assert initialize_from_env(env={}) is False
    assert num_slices() == 1


def _hybrid_rank():
    mesh = build_hybrid_mesh(replica=2, data=2, model=2, seq=1)
    plain = build_mesh(MeshConfig(data=4, model=2, seq=1))
    return (tuple(mesh.mesh_dim_names), C.mesh_shape(mesh),
            dp_spec(mesh, 3), dp_spec(plain, 2), num_slices())


def test_hybrid_mesh_axes_and_dp_spec():
    names, shape, hybrid_spec, plain_spec, hosts = run_ranks(
        _hybrid_rank, 8, device="cpu", timeout=120)[0]
    assert names == HYBRID_AXES
    assert shape == {"replica": 2, "data": 2, "model": 2, "seq": 1}
    assert hybrid_spec == (("replica", "data"), None, None)
    assert plain_spec == ("data", None)
    assert hosts == 1
    with pytest.raises(ValueError, match="mesh needs 16 devices"):
        build_hybrid_mesh(replica=16, data=1)


def _failing_rank(mode):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        if mode == "raise":
            raise ValueError("rank one fails")
        time.sleep(600)
    dist.barrier()


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_run_ranks_raises_when_a_rank_fails_or_hangs(mode):
    """A rank that raises fails the call at once, with its traceback (the
    other rank waits in a barrier and is killed); a rank that hangs fails
    it at the timeout."""
    t0 = time.monotonic()
    if mode == "raise":
        with pytest.raises(RuntimeError, match="rank one fails"):
            run_ranks(_failing_rank, 2, device="cpu", args=(mode,),
                      timeout=120)
        assert time.monotonic() - t0 < 60
    else:
        with pytest.raises(TimeoutError, match="did not finish within 10"):
            run_ranks(_failing_rank, 2, device="cpu", args=(mode,),
                      timeout=10)
        assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("failed_joins,ok", [(0, True), (1, True),
                                              (2, True), (3, False)])
def test_run_ranks_starts_a_group_again_when_its_ranks_fail_to_join(
        monkeypatch, failed_joins, ok):
    """A group whose ranks fail in ``init_process_group`` (gloo's
    full-mesh connect, "Connection closed by peer", when other groups
    start at the same moment) is started again in a fresh store, up to
    ``JOIN_TRIES`` times within the one deadline; a rank's own failure is
    not retried."""
    from janus_tpu_torch.parallel import launch

    starts = []

    def run_group(*a):
        starts.append(a[-1])  # the deadline, one for every start
        if len(starts) <= failed_joins:
            raise launch._JoinError("rank 0 of 2 failed:\nConnection "
                                    "closed by peer")
        return ["rank 0", "rank 1"]

    monkeypatch.setattr(launch, "_run_group", run_group)
    if ok:
        assert run_ranks(_failing_rank, 2, device="cpu") == ["rank 0",
                                                            "rank 1"]
    else:
        with pytest.raises(RuntimeError, match="started 3 times"):
            run_ranks(_failing_rank, 2, device="cpu")
    assert len(starts) == min(failed_joins + 1, launch.JOIN_TRIES)
    assert len(set(starts)) == 1

    def rank_fails(*a):
        starts.append(a[-1])
        raise RuntimeError("rank 1 of 2 failed: its own error")

    starts.clear()
    monkeypatch.setattr(launch, "_run_group", rank_fails)
    with pytest.raises(RuntimeError, match="its own error"):
        run_ranks(_failing_rank, 2, device="cpu")
    assert len(starts) == 1


def _helper_children() -> set:
    """This process's children that are multiprocessing helpers: the
    forkserver and the resource tracker."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids.update(int(p) for p in f.read().split())
    found = set()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except FileNotFoundError:
            continue
        if b"forkserver" in cmd or b"resource_tracker" in cmd:
            found.add(pid)
    return found


def test_stop_rank_server_stops_the_helpers_and_run_ranks_starts_them_again():
    assert run_ranks(os.getpid, 2, device="cpu", timeout=120)
    assert len(_helper_children()) == 2
    stop_rank_server()
    assert _helper_children() == set()
    assert len(set(run_ranks(os.getpid, 2, device="cpu", timeout=120))) == 2


def test_no_rank_process_outlives_its_caller():
    """A program that ran a group leaves no process behind when it exits:
    none of its session is alive once it has been reaped."""
    code = ("import os; from janus_tpu_torch.parallel.launch import "
            "run_ranks; print(run_ranks(os.getpid, 2, device='cpu', "
            "timeout=120))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=180)
    assert proc.returncode == 0 and out.strip().startswith(b"["), (
        proc.returncode, out[-200:], err[-2000:].decode(errors="replace"))
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")[:160]
        except (FileNotFoundError, ProcessLookupError):
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[3]) == proc.pid and fields[0] != "Z":
            left.append((pid, fields[0], cmd))
    assert left == []
