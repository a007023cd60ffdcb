"""What the CPU can hold of the H100 redesign of K2 (flash attention) and
K4 (int8 cross-attention): the route function, the tensor-core kernel's
tile arithmetic and the split-T combine emulated in PyTorch against the
plain versions (and K4 against the JAX package's Pallas kernel in
interpret mode), the padded ``QuantKVT`` rows against the JAX package's
``quantize_kv_t``, and the wrapper's pure helpers. The kernels themselves
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.ops import quant as jq
from janus_tpu.ops.cross_attn import cross_attention_kv as j_cross
from janus_tpu_torch.ops import quant as tq
from janus_tpu_torch.ops.cross_attn import (MAX_SPLITS, TILE, _rows,
                                            cross_attention_int8_plain,
                                            load_bytes, plan_splits)
from janus_tpu_torch.ops.flash import attend_bh, flash_forward, flash_route

LOG2E = 1.4426950408889634


# -- (a) which kernel takes which input --------------------------------------

@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.float32, 64, "simt"),
    (torch.float32, 32, "simt"),
    (torch.bfloat16, 32, "simt"),
])
def test_flash_route(dtype, head_dim, route):
    assert flash_route(dtype, head_dim) == route


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 32, TypeError),
    (torch.bfloat16, 128, ValueError),
    (torch.float32, 48, ValueError),
])
def test_flash_route_rejects(dtype, head_dim, error):
    with pytest.raises(error):
        flash_route(dtype, head_dim)


def test_flash_forward_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 9, 64), generator=g) for _ in range(3))
    torch.testing.assert_close(flash_forward(q, k, v, True),
                               attend_bh(q, k, v, True), rtol=0, atol=0)


# -- (b) the tensor-core kernel's arithmetic ---------------------------------

def flash_tiled(q, k, v, causal, block_k=64):
    """The wgmma kernel's arithmetic in PyTorch: 64-key tiles, raw scores in
    fp32 with the -1e30 fill before the max, a running max, exponentials in
    base 2 with ``Dh^-1/2 log2(e)`` folded into one multiply-add, the row
    sum over the unrounded p, p rounded to ``v.dtype`` per tile, fp32
    accumulation, ``/ max(l, 1e-30)``, one rounding to ``q.dtype``."""
    bh, t_q, dh = q.shape
    t_k = k.shape[1]
    c = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((bh, t_q, 1), -math.inf)
    l = torch.zeros((bh, t_q, 1))
    o = torch.zeros((bh, t_q, dh))
    rows = torch.arange(t_q)[:, None]
    for k0 in range(0, t_k, block_k):
        cols = torch.arange(k0, k0 + block_k)[None, :]
        kt = torch.zeros((bh, block_k, dh))
        vt = torch.zeros((bh, block_k, dh))
        n = min(block_k, t_k - k0)
        kt[:, :n] = k[:, k0:k0 + n].float()   # the copy zero-fills the tail
        vt[:, :n] = v[:, k0:k0 + n].float()
        s = torch.matmul(q.float(), kt.transpose(-1, -2))
        ok = cols < t_k
        if causal:
            ok = ok & (cols <= rows)
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(v.dtype).float(), vt)
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)).to(q.dtype)


FLASH_BARS = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2 ** -6, 5e-3)}


def _qkv(t_q, t_k, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (3, t, 64)).astype(np.float32)).to(dtype) for t in (t_q, t_k, t_k))


@pytest.mark.parametrize("dtype", list(FLASH_BARS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 52, 64, 65, 500])
def test_flash_tile_arithmetic_matches_plain(t, causal, dtype):
    q, k, v = _qkv(t, t, dtype, seed=t)
    rtol, atol = FLASH_BARS[dtype]
    out = flash_tiled(q, k, v, causal)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), attend_bh(q, k, v, causal).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(FLASH_BARS))
@pytest.mark.parametrize("t_q,t_k", [(130, 500), (1, 65), (64, 52)])
def test_flash_tile_arithmetic_key_length_differs(t_q, t_k, dtype):
    q, k, v = _qkv(t_q, t_k, dtype, seed=t_q + t_k)
    rtol, atol = FLASH_BARS[dtype]
    torch.testing.assert_close(flash_tiled(q, k, v, False).float(),
                               attend_bh(q, k, v, False).float(),
                               rtol=rtol, atol=atol)


# -- (c) K4: the split of T and its combine ----------------------------------

def cross_split(q, k, v, splits):
    """The K4 kernel's arithmetic in PyTorch: tiles of ``TILE`` positions
    dealt round-robin to ``splits`` blocks, each with a running max, sum
    and unnormalised output, then ``o = sum_s e^(m_s - m) o_s /
    max(sum_s e^(m_s - m) l_s, 1e-30)`` in the order of the splits. A block
    without a tile leaves ``m = -inf, l = 0, o = 0``."""
    dh, t = k.q.shape[-2:]
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    qf = q.float()
    parts = []
    for split in range(splits):
        m = torch.full(q.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape, dtype=torch.float32)
        for t0 in range(split * TILE, t, splits * TILE):
            sl = slice(t0, min(t0 + TILE, t))
            s = torch.matmul(qf, k.q[..., sl].float()) * scale
            s = s * k.scale[..., None, sl]
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.matmul(
                p * v.scale[..., None, sl],
                v.q[..., sl].float().transpose(-1, -2))
            m = m_new
        parts.append((m, l, o))
    m = functools.reduce(torch.maximum, [p[0] for p in parts])
    num = sum(torch.exp(pm - m) * po for pm, _, po in parts)
    den = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    return (num / torch.clamp_min(den, 1e-30)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _cross_case(t, tq_len):
    """Seeded inputs, the port's plain version and the JAX package's Pallas
    kernel (interpret mode) on them."""
    rng = np.random.default_rng(100 + t)
    b, h, dh = 2, 3, 64
    q = rng.standard_normal((b, h, tq_len, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    tk, tv = (tq.quantize_kv_t(torch.from_numpy(a)) for a in (k, v))
    plain = cross_attention_int8_plain(torch.from_numpy(q), tk, tv)
    jk, jv = jq.quantize_kv_t(jnp.asarray(k)), jq.quantize_kv_t(jnp.asarray(v))
    ref = np.asarray(j_cross(jnp.asarray(q), jk, jv, force=True))
    return torch.from_numpy(q), tk, tv, plain, ref


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("t,tq_len", [(1, 1), (77, 1), (499, 1), (500, 1),
                                      (499, 3)])
def test_cross_split_combine_matches_plain_and_jax(t, tq_len, splits):
    q, k, v, plain, ref = _cross_case(t, tq_len)
    out = cross_split(q, k, v, splits)
    assert bool(torch.isfinite(out).all())
    # fp32: the split changes only the order of the sums
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t,splits", [(1, 1), (128, 1), (129, 2), (256, 2),
                                      (500, 4), (1500, 4), (3000, 4)])
def test_plan_splits(t, splits):
    got = plan_splits(t)
    assert got == splits
    # a power of two, never more blocks than tiles, never past the cap
    assert got & (got - 1) == 0 and got <= MAX_SPLITS
    assert got <= -(-t // TILE)


@pytest.mark.parametrize("alignments,width", [
    ((256, 512, 512, 512), 16), ((256, 256, 500, 500), 4),
    ((256, 260, 512, 512), 4), ((256, 256, 499, 499), 1),
    ((257, 256, 512, 512), 1)])
def test_load_bytes(alignments, width):
    assert load_bytes(*alignments) == width


# -- (d) QuantKVT with rows padded to 16 bytes -------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 17, 77, 500, 512])
def test_quantize_kv_t_padded_rows_equal_jax(t, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = (0.05 * np.random.default_rng(t).standard_normal((2, 3, t, 64))
         ).astype(np.float32)
    x[..., 0, :] = 0.0  # an all-zero position takes the 1e-8 floor
    ref = jq.quantize_kv_t(jnp.asarray(x, dtype=jdt))
    out = tq.quantize_kv_t(torch.from_numpy(x).to(tdt))
    assert tuple(out.q.shape) == (2, 3, 64, t) and out.q.shape[-1] == t
    assert tuple(out.scale.shape) == (2, 3, t)
    assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        tq.dequant_kv(out, torch.float32).numpy(),
        np.asarray(jq.dequant_kv(ref, jnp.float32)))
    # rows start 16-byte aligned, and the wrapper takes them as they are
    assert out.q.stride(-1) == 1 and out.q.stride(-2) % 16 == 0
    rows, stride = _rows(out.q)
    assert rows is out.q and stride == out.q.stride(-2)


def test_rows_copies_only_what_it_cannot_take():
    kv = tq.quantize_kv_t(torch.randn((2, 3, 50, 64),
                                      generator=torch.Generator().manual_seed(
                                          0)))
    dense = kv.q.contiguous()
    assert _rows(dense) == (dense, 50) and _rows(dense)[0] is dense
    # batch and heads swapped: no single stride between consecutive rows
    swapped = kv.q.transpose(0, 1)
    rows, stride = _rows(swapped)
    assert rows is not swapped and rows.is_contiguous() and stride == 50
    torch.testing.assert_close(rows, swapped, rtol=0, atol=0)
    # positions strided: rows are not of unit stride
    strided = kv.q[..., ::2]
    rows, stride = _rows(strided)
    assert rows.is_contiguous() and stride == 25
