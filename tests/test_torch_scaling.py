"""The port's scaling analysis on the CPU: the collectives' byte counts on
8 gloo ranks against the sizes the JAX package's golden test computes by
hand for the same four programs (``tests/test_scaling.py``), the modeled
weak-scaling rows at N in {1, 2} on ``H100Roofline``, the wall-clock
rows' shape, and the bytes-accessed counter.

The port's collectives are explicit and are counted where they run, so
the JAX package's HLO-parser tests have no counterpart here. The rank
functions are module-level, and every rank imports this module: nothing
of JAX is imported."""

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.eval.scaling import (BytesAccessed, H100Roofline,
                                          analyze_encode_scaling,
                                          collective_bytes,
                                          measure_wallclock_scaling)
from janus_tpu_torch.parallel import collectives as C
from janus_tpu_torch.parallel.launch import run_ranks

SMALL = {
    "asr.d_model": 64, "asr.encoder_layers": 2, "asr.decoder_layers": 2,
    "asr.num_heads": 4, "asr.vocab_size": 300,
    "asr.max_source_positions": 128, "asr.max_decode_tokens": 4,
}


def _golden_rank():
    """The four shard_map programs of the JAX golden test, each rank
    holding its row of the global array."""
    import torch.distributed as dist

    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("x",))
    r = dist.get_rank()
    x = torch.arange(8 * 1024, dtype=torch.float32).reshape(8, 1024)[r:r + 1]
    y = torch.ones((8, 256))[r:r + 1]
    z = torch.ones((8, 512))[r:r + 1]
    w = torch.ones((8, 8, 64))[r:r + 1]
    return [
        collective_bytes(C.all_reduce, x, mesh, "x"),
        collective_bytes(C.all_gather, y.squeeze(0), mesh, "x", tiled=False),
        collective_bytes(C.ppermute, z, mesh, "x"),
        collective_bytes(C.all_to_all, w, mesh, "x", split_dim=1,
                         concat_dim=0),
        # and the fifth op the counter names: psum_scatter of f32[8, 4]
        collective_bytes(C.reduce_scatter, torch.ones((8, 4)), mesh, "x"),
    ]


def test_collective_bytes_golden_programs():
    """Every rank counts exactly the JAX golden test's hand-computed
    result sizes: psum of f32[1024], all_gather into f32[8, 256],
    ppermute of f32[1, 512], all_to_all into f32[8, 1, 64]."""
    for counts in run_ranks(_golden_rank, 8, device="cpu", timeout=120):
        assert counts == [{"all-reduce": 1024 * 4},
                          {"all-gather": 8 * 256 * 4},
                          {"collective-permute": 512 * 4},
                          {"all-to-all": 8 * 64 * 4},
                          {"reduce-scatter": 4 * 4}]


def test_size_one_dimension_issues_nothing():
    """A dimension of size 1 issues no collective and counts nothing, as
    XLA elides such collectives."""
    from janus_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh()
    t = torch.ones(4)
    with C.counting() as counts:
        assert C.all_reduce(t, mesh, "model") is t
        assert C.all_gather(t, mesh, "seq") is t
        assert C.ppermute(t, mesh, "seq") is t
    assert counts == {}


def test_modeled_weak_scaling_meets_target():
    """The encode program at N = 1 and 2 (data 2): per-device FLOPs stay
    flat (no replicated work grows with the batch) and the modeled
    efficiency on the H100 roofline is at least 0.8."""
    cfg = JanusConfig().override(**SMALL)
    rows = analyze_encode_scaling(device_counts=(1, 2), seconds=1.0,
                                  cfg=cfg, per_device_batch=2, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    f1, f2 = rows[0]["per_device_flops"], rows[1]["per_device_flops"]
    assert 0 < f2 < 1.15 * f1, (f1, f2)
    assert rows[0]["collective_bytes"] == {}
    # the results are all-gathered over "data": 5 arrays of 2 lanes each
    assert set(rows[1]["collective_bytes"]) == {"all-gather"}
    assert rows[1]["modeled_weak_scaling_efficiency"] >= 0.8, rows
    assert all(r["per_device_hbm_bytes"] > 0 and r["device"] == "cpu"
               for r in rows)
    # on the CPU the kernels' plain versions run, counted as aten ops
    assert all(r["kernel_work"] == {} and r["replicated"] == ["frontend"]
               for r in rows)


def test_wallclock_weak_scaling_rows():
    cfg = JanusConfig().override(**SMALL)
    rows = measure_wallclock_scaling(device_counts=(1, 2), seconds=1.0,
                                     cfg=cfg, per_device_batch=2, iters=2,
                                     device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["wallclock_efficiency_vs_linear"] == 1.0
    assert rows[1]["wallclock_step_s"] > 0
    assert len(rows[1]["wallclock_all_s"]) == 2


def test_bytes_accessed_counts_operands_and_results():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with BytesAccessed() as counter:
        a.t()  # a view moves nothing
        torch.matmul(a, b)
    assert counter.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    rl = H100Roofline()
    assert (rl.peak_bf16_flops, rl.hbm_bw, rl.link_bw) == (989e12, 3.35e12,
                                                           450e9)
    assert np.isclose(rl.tensor_util, 0.5) and np.isclose(rl.hbm_util, 0.8)
