"""What the CPU can hold of the dynamic-int8 linear's kernel
(``csrc/int8_linear.cu``): its plain version against the JAX package's
``linear_int8_dynamic`` bit for bit (row counts below, at and above the
card's 8-row tiles, fp32 and bf16 activations, with and without a bias, an
all-zero row, values at exact ties of ``x / x_scale``); the card's plain
int32 product (float64) exact at the widest K; ``column_major``, the
weight layout the kernel reads; the split plan; the wrapper refusing a CPU
tensor; and ``SemanticEncoder`` on the CPU running the plain version, the
kernel never. The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.ops import quant as jq
from janus_tpu_torch.audio.synthetic import render_text
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models.params import (cast_floating, init_asr,
                                           prepare_decode_params)
from janus_tpu_torch.ops import int8_linear as i8
from janus_tpu_torch.ops import quant as tq
from janus_tpu_torch.runtime.codec import SemanticEncoder

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, n, seed):
    """x with an all-zero first row (where there are two rows or more) and
    a last row at exact ties: amax 127 gives x_scale 1, so 2.5, -3.5, 0.5
    and -0.5 round half to even; a row of amax 254 (x_scale 2) gives ties
    at 5 and -7. Every value is exact in bf16."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((m, k))).astype(np.float32)
    ties = np.resize(np.array([2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                              np.float32), k)
    ties[0] = 127.0
    x[-1] = ties
    if m >= 3:
        x[-2] = 2.0 * ties
    if m >= 2:
        x[0] = 0.0
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,n", [(128, 512), (512, 128), (160, 96)])
@pytest.mark.parametrize("m", [1, 8, 17, 33])
def test_plain_bit_equal_to_jax(m, k, n, dtype, with_bias):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(m, k, n, seed=m * 1000 + k + n)
    jw = jq.quantize_weight(jnp.asarray(w))
    jb = jnp.asarray(b) if with_bias else None
    ref = np.asarray(jq.linear_int8_dynamic(jnp.asarray(x, dtype=jdt), jw,
                                            jb).astype(jnp.float32))
    qw = tq.DynQuantizedWeight(torch.from_numpy(np.array(jw.q)),
                               torch.from_numpy(np.array(jw.scale)))
    tb = torch.from_numpy(b) if with_bias else None
    out = i8.int8_linear_plain(torch.from_numpy(x).to(tdt), qw, tb)
    assert out.dtype == tdt and out.shape == (m, n)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    # the weight as the card's tree stores it (K-contiguous), the same bits
    out_cols = i8.int8_linear_plain(torch.from_numpy(x).to(tdt),
                                    tq.column_major(qw), tb)
    assert torch.equal(out_cols, out)


def test_plain_quantizes_ties_half_to_even_and_zero_rows():
    x, w, _ = _inputs(3, 128, 64, seed=0)
    xf = torch.from_numpy(x)
    scale = i8._scale_of(xf.abs().amax(dim=-1, keepdim=True))
    xq = i8._round_int8(xf / scale)
    assert scale[:, 0].tolist() == [np.float32(1e-8) / np.float32(127),
                                    2.0, 1.0]
    assert not xq[0].any()
    assert xq[2, :7].tolist() == [127, -4, 0, 0, 2, 126, -126]
    assert xq[1, :7].tolist() == [127, -4, 0, 0, 2, 126, -126]


def test_card_plain_product_is_exact_at_the_widest_k():
    """The plain version's int32 product on the card is a float64 product:
    every partial sum is an integer below 2^53, so it equals the int8
    product at the extremes of large-v3's widest K (5120)."""
    k = 5120
    xq = torch.full((4, k), 127, dtype=torch.int8)
    xq[1] = -127
    xq[2, ::2] = -127
    xq[3] = torch.from_numpy(np.random.default_rng(3).integers(
        -127, 128, k).astype(np.int8))
    q = xq.t()[:, [0, 1, 2, 3, 0, 1, 2, 3]].contiguous()
    exact = torch._int_mm(xq, q)
    assert int(exact.abs().max()) == 127 * 127 * k
    got = torch.matmul(xq.double(), q.double()).to(torch.int32)
    assert torch.equal(got, exact)


def _tree(mode):
    cfg = ASRConfig.demo()
    tree = cast_floating(init_asr(torch.Generator().manual_seed(0), cfg),
                         torch.bfloat16)
    return prepare_decode_params(tq.quantize_tree(tree, mode=mode))


def _leaves(tree, path=""):
    """(path, leaf) with quantized pairs as leaves."""
    if isinstance(tree, (tq.QuantizedWeight, tq.DynQuantizedWeight)):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


@pytest.mark.parametrize("mode", ["weight", "dynamic"])
def test_column_major_keeps_leaves_and_is_idempotent(mode):
    tree = _tree(mode)
    before = _leaves(tree)
    cols = tq.column_major(tree)
    after = _leaves(cols)
    assert [p for p, _ in after] == [p for p, _ in before]
    n_dyn = 0
    for (path, old), (_, new) in zip(before, after):
        assert type(new) is type(old), path
        if isinstance(old, tq.DynQuantizedWeight):
            n_dyn += 1
            assert new.q.shape == old.q.shape and new.q.dtype == torch.int8
            assert torch.equal(new.q, old.q), path
            assert new.scale is old.scale
            assert new.q.stride() == (1, old.q.shape[0]), path
            assert i8.k_contiguous(new.q)
            assert old.q.is_contiguous()  # the caller's tree is untouched
        else:
            assert new is old, path  # nothing but DynQuantizedWeight moves
    assert n_dyn == (0 if mode == "weight" else
                     sum(isinstance(v, tq.DynQuantizedWeight)
                         for _, v in before)) and (mode == "weight" or n_dyn)
    again = _leaves(tq.column_major(cols))
    assert all(a is b for (_, a), (_, b) in zip(again, after))


def test_fuse_qkv_after_column_major_is_row_major_again():
    """Why the conversion comes after ``prepare_decode_params``: the fused
    q/k/v concatenation is row-major whatever its inputs."""
    cfg = ASRConfig.demo()
    tree = tq.column_major(tq.quantize_tree(init_asr(
        torch.Generator().manual_seed(1), cfg), mode="dynamic"))
    fused = prepare_decode_params(tree)["decoder"]["blocks"][0]["attn"]
    assert not i8.k_contiguous(fused["qkv"]["w"].q)
    assert i8.k_contiguous(
        tq.column_major(fused)["qkv"]["w"].q)


@pytest.mark.parametrize("m,k,n,want", [
    (8, 1280, 3840, 8), (8, 1280, 1280, 8), (8, 1280, 5120, 8),
    (8, 5120, 1280, 8), (64, 1280, 1280, 8), (32, 5120, 1280, 8),
    (1, 1280, 1280, 8), (8, 128, 384, 4), (8, 512, 128, 8), (8, 64, 64, 2),
    (65, 1280, 1280, 0), (128, 1280, 1280, 0), (4000, 1280, 1280, 0),
    (4000, 1280, 5120, 0), (4001, 1280, 100, 0), (6400, 5120, 1280, 0)])
def test_plan_splits(m, k, n, want):
    """The streamed product's split plan: four blocks an SM, 0 above 64
    rows (the persistent warpgroup product)."""
    splits = i8.plan_splits(m, k, n, sms=132)
    assert splits == want
    if splits:
        # every block of a cluster has at least one k-step
        assert splits & (splits - 1) == 0 and k // i8.K_STEP >= splits


def test_use_pdl_by_rows():
    """The streamed product overlaps the quantization up to 32 rows; the
    warpgroup product (above 64) always, its quantization overlapping the
    kernel before it."""
    assert i8.use_pdl(1) and i8.use_pdl(8) and i8.use_pdl(32)
    assert not i8.use_pdl(33) and not i8.use_pdl(64)
    assert i8.use_pdl(65) and i8.use_pdl(4000)


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_amax_in_one_split_bit_equal_to_jax(dtype, where):
    """Rows whose largest |x| lies only in the first or only in the last
    eighth of K (the first or last block of the card's 8-block cluster at
    1280 x 1280): the plain version takes the whole row's amax, bit for
    bit as the JAX package does."""
    jdt, tdt = DTYPES[dtype]
    k, n = 1280, 96
    x, w, b = _inputs(4, k, n, seed=7)
    span = k // 8
    lo = 0 if where == "first" else k - span
    x = np.clip(x, -1, 1)
    for r in (1, 3):
        x[r, lo + 11 * r] = 40.0 * (-1) ** r
    jw = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq.linear_int8_dynamic(jnp.asarray(x, dtype=jdt), jw,
                                            jnp.asarray(b)).astype(
                                                jnp.float32))
    qw = tq.DynQuantizedWeight(torch.from_numpy(np.array(jw.q)),
                               torch.from_numpy(np.array(jw.scale)))
    xt = torch.from_numpy(x).to(tdt)
    out = i8.int8_linear_plain(xt, qw, torch.from_numpy(b))
    np.testing.assert_array_equal(out.float().numpy(), ref)
    scale = i8._scale_of(xt.float().abs().amax(dim=-1, keepdim=True))
    assert scale[1, 0] == scale[3, 0] == np.float32(40.0) / np.float32(127)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    x, w, b = _inputs(8, 128, 64, seed=1)
    qw = tq.column_major(tq.DynQuantizedWeight(*tq.quantize_weight(
        torch.from_numpy(w))))
    before = i8.KERNEL.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        i8.int8_linear(torch.from_numpy(x), qw, torch.from_numpy(b))
    assert i8.KERNEL.launches == before


@pytest.mark.parametrize("layout", ["row_major", "column_major"])
def test_linear_int8_dynamic_on_the_cpu_is_the_plain_version(layout):
    x, w, b = _inputs(17, 160, 96, seed=2)
    qw = tq.DynQuantizedWeight(*tq.quantize_weight(torch.from_numpy(w)))
    if layout == "column_major":
        qw = tq.column_major(qw)
    before = i8.KERNEL.launches
    out = tq.linear_int8_dynamic(torch.from_numpy(x), qw, torch.from_numpy(b))
    assert torch.equal(out, i8.int8_linear_plain(torch.from_numpy(x), qw,
                                                 torch.from_numpy(b)))
    assert i8.KERNEL.launches == before


def test_semantic_encoder_on_the_cpu_never_launches_the_kernel():
    cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.demo()).override(
        **{"asr.decode_cross_kv_int8": True, "asr.max_decode_tokens": 4})
    params = tq.quantize_tree(init_asr(torch.Generator().manual_seed(2),
                                       cfg.asr), mode="dynamic")
    enc = SemanticEncoder(cfg, asr_params=params, buckets=(48_000,),
                          device="cpu")
    # the CPU keeps the row-major layout: no conversion is made for it
    qkv = enc.params["decoder"]["blocks"][0]["attn"]["qkv"]["w"]
    assert type(qkv) is tq.DynQuantizedWeight and qkv.q.is_contiguous()
    before = i8.KERNEL.launches
    out = enc.encode_batch([render_text("alpha", 48_000, seed=0)])
    assert len(out) == 1
    assert i8.KERNEL.launches == before


def test_rounding_by_the_reciprocal_equals_the_division():
    """The kernel's quantization (``csrc/int8_linear.cu`` ``quantize16``)
    rounds ``x * (1 / s)`` and asks the IEEE division only where that
    product lies within 2^-14 of a half-integer: emulated in float32 here,
    it equals ``rint(x / s)`` on every value of random rows, their exact
    ties and their neighbours one float32 step away, and the near cases
    are rare."""
    rng = np.random.default_rng(11)
    x = (3.0 * rng.standard_normal((64, 4096))).astype(np.float32)
    x[:, :7] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5, -126.5]
    xt = torch.from_numpy(x)
    s = i8._scale_of(xt.abs().amax(dim=-1, keepdim=True))
    # half-integer multiples of each row's scale and their float neighbours
    ties = (torch.arange(-127, 128, dtype=torch.float32) + 0.5) * s
    xt = torch.cat([xt, ties, torch.nextafter(ties, ties + 1),
                    torch.nextafter(ties, ties - 1)], dim=-1)
    exact = torch.round(xt / s)
    r = torch.ones((), dtype=torch.float32) / s
    t = xt * r
    near = (t - (torch.floor(t) + 0.5)).abs() < 2.0 ** -14
    got = torch.where(near, exact, torch.round(t))
    assert torch.equal(got, exact)
    assert 0 < near.float().mean() < 0.2
    assert near[:, 7:4096].float().mean() < 1e-3
