"""What the CPU can hold of the decode steps' two kernels and the head
widened once: the plain layer norm (alone and after the residual add it
takes in) and the plain decode attention (alone and writing the step's new
rows into the cache) against the JAX package at the steps' shapes (fp32,
bf16, fp32 activations over bf16 parameters and caches, a device fill
position, stale slots past the fill), the fused calls bit-equal to the
port's unfused sequences, numpy emulations of each kernel's order of sums
and split plan against the plain versions, the route function, and the
recognizer's once-widened head against the per-call cast, bit for bit.
The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.ops.attention import KVCache as JKVCache
from janus_tpu.ops.attention import attend as j_attend
from janus_tpu.ops.layers import layer_norm as j_layer_norm
from janus_tpu_torch.ops.attention import KVCache
from janus_tpu_torch.ops.decode_attention import (MAX_ROWS, SCORE_BYTES,
                                                  attend_cache,
                                                  decode_attention,
                                                  decode_attention_plain,
                                                  decode_route,
                                                  keys_per_pass,
                                                  lanes_per_position,
                                                  plan_splits, score_bytes)
from janus_tpu_torch.ops.layers import (add_layer_norm, layer_norm,
                                        layer_norm_plain)

BF16_BAR = (2 ** -6, 5e-3)   # K2's bf16 bar: rtol, atol
FP32_BAR = (0.0, 2e-5)       # K2's fp32 bar


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _j(t: torch.Tensor):
    """The tensor for JAX, in its own dtype."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _ratio(out, ref, rtol, atol) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (atol + rtol * np.abs(ref))).max())


def _bf16_ulps(out, ref) -> np.ndarray:
    """|out - ref| in units of ref's bf16 ulp."""
    ref = np.asarray(ref, np.float64)
    ulp = np.where(ref != 0, 2.0 ** (np.floor(np.log2(np.abs(ref)
                                                      + 1e-300)) - 7),
                   2.0 ** -133)
    return np.abs(np.asarray(out, np.float64) - ref) / ulp


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# -- (a) the plain layer norm against the JAX package ------------------------

def _ln_inputs(shape, x_dtype, p_dtype, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy((3 * rng.standard_normal(shape) + 1).astype(
        np.float32)).to(x_dtype)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(p_dtype)
    bias = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(p_dtype)
    return x, scale, bias


@pytest.mark.parametrize("x_dtype,p_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),     # the TTS step's mixed case
], ids=["fp32", "bf16", "fp32-x-bf16-params"])
@pytest.mark.parametrize("shape", [(8, 1, 256), (3, 17, 96)])
def test_plain_layer_norm_matches_jax(shape, x_dtype, p_dtype):
    x, scale, bias = _ln_inputs(shape, x_dtype, p_dtype, seed=shape[-1])
    got = layer_norm_plain(x, scale, bias)
    want = np.asarray(j_layer_norm(_j(x), _j(scale), _j(bias)), np.float32)
    assert got.dtype == x_dtype and got.shape == x.shape
    if x_dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    else:  # both round once from fp32: at most one bf16 ulp apart
        assert _bf16_ulps(_np(got), want).max() <= 1.0
    # on a CPU tensor the routed function is the plain body, bit for bit
    assert torch.equal(layer_norm(x, scale, bias), got)


# -- (b) the plain decode attention against the JAX package ------------------

def _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill, seed):
    """q, and a cache whose first ``fill + tq`` slots hold this step's keys
    and every slot past them a stale non-zero value (an earlier prompt's)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(
        np.float32)).to(q_dtype)
    k, v = (torch.from_numpy((s * rng.standard_normal((b, h, t, dh)))
                             .astype(np.float32)).to(kv_dtype)
            for s in (2.0, 1.0))
    return q, k, v


@pytest.mark.parametrize("tq,fill,q_dtype,kv_dtype", [
    (1, 9, torch.bfloat16, torch.bfloat16),    # the recognizer's step
    (4, 0, torch.bfloat16, torch.bfloat16),    # its 4-token prompt prefill
    (1, 20, torch.float32, torch.bfloat16),    # the TTS step: fp32 q
    (1, 5, torch.float32, torch.float32),      # the demo's fp32 step
    (4, 3, torch.bfloat16, torch.float32),     # bf16 q over an fp32 cache
])
def test_plain_decode_attention_matches_jax_with_the_cache_mask(
        tq, fill, q_dtype, kv_dtype):
    b, h, t, dh = 2, 3, 28, 64
    q, k, v = _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill, seed=tq)
    pos = torch.tensor(fill)  # the device fill point, before the write
    got = decode_attention_plain(q, k, v, pos)
    jcache = JKVCache(k=_j(k), v=_j(v),
                      length=jnp.full((b,), fill + tq, jnp.int32))
    want = np.asarray(j_attend(_j(q), jcache.k, jcache.v,
                               jcache.valid_mask(tq)), np.float32)
    rtol, atol = FP32_BAR if kv_dtype == torch.float32 else BF16_BAR
    assert got.dtype == q_dtype and got.shape == q.shape
    assert _ratio(_np(got), want, rtol, atol) <= 1.0
    # a host int fill point and the routed function on the CPU give the same
    assert torch.equal(decode_attention_plain(q, k, v, fill), got)
    assert torch.equal(decode_attention(q, k, v, pos), got)
    # the stale slots past the fill change nothing
    k2, v2 = k.clone(), v.clone()
    k2[..., fill + tq:, :] = 1e3
    v2[..., fill + tq:, :] = -7.0
    assert torch.equal(decode_attention_plain(q, k2, v2, pos), got)


@pytest.mark.parametrize("tq", [1, 4])
def test_plain_cross_attention_matches_jax(tq):
    """No mask: the recognizer's dense cross-attention (bf16 K/V as the
    encoder's heads split them, a strided view)."""
    b, h, t, dh = 2, 3, 100, 64
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(
        np.float32)).to(torch.bfloat16)
    kv = [torch.from_numpy(rng.standard_normal((b, t, h * dh)).astype(
        np.float32)).to(torch.bfloat16).reshape(b, t, h, dh).movedim(-2, -3)
        for _ in range(2)]
    got = decode_attention(q, *kv)
    want = np.asarray(j_attend(_j(q), _j(kv[0]), _j(kv[1])), np.float32)
    assert _ratio(_np(got), want, *BF16_BAR) <= 1.0


# -- (b2) the cache written by the call ------------------------------------

def _new_rows(b, h, tq, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((s * rng.standard_normal((b, h, tq, dh)))
                                  .astype(np.float32)).to(dtype)
                 for s in (2.0, 1.0))


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("tq,fill,q_dtype,kv_dtype", [
    (1, 9, torch.bfloat16, torch.bfloat16),    # the recognizer's step
    (4, 0, torch.bfloat16, torch.bfloat16),    # its 4-token prompt prefill
    (1, 20, torch.float32, torch.bfloat16),    # the TTS step: fp32 rows
    (1, 5, torch.float32, torch.float32),      # the demo's fp32 step
    (4, 3, torch.float32, torch.float32),
])
def test_fused_write_matches_jax_cache_write_and_attend(tq, fill, q_dtype,
                                                        kv_dtype, on_device):
    """``decode_attention(q, k, v, pos, k_new, v_new)`` against the JAX
    package's ``KVCache.append_lockstep`` (``janus_tpu/ops/attention.py:
    135-136``) and ``attend`` (``:43``) with its ``valid_mask``: the written
    cache equal, the output within the bars."""
    b, h, t, dh = 2, 3, 28, 64
    q, k, v = _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill, seed=tq)
    k_new, v_new = _new_rows(b, h, tq, dh, q_dtype, seed=fill + 11)
    jcache = JKVCache(k=_j(k), v=_j(v),
                      length=jnp.full((b,), fill, jnp.int32)
                      ).append_lockstep(_j(k_new), _j(v_new))
    want = np.asarray(j_attend(_j(q), jcache.k, jcache.v,
                               jcache.valid_mask(tq)), np.float32)
    pos = torch.tensor(fill) if on_device else fill
    got = decode_attention(q, k, v, pos, k_new, v_new)
    assert got.dtype == q_dtype and got.shape == q.shape
    np.testing.assert_array_equal(_np(k), np.asarray(jcache.k, np.float32))
    np.testing.assert_array_equal(_np(v), np.asarray(jcache.v, np.float32))
    rtol, atol = FP32_BAR if (q_dtype, kv_dtype) == (
        torch.float32, torch.float32) else BF16_BAR
    assert _ratio(_np(got), want, rtol, atol) <= 1.0


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("tq,fill,q_dtype,kv_dtype", [
    (1, 9, torch.bfloat16, torch.bfloat16),
    (4, 0, torch.bfloat16, torch.bfloat16),
    (1, 20, torch.float32, torch.bfloat16),
    (2, 26, torch.bfloat16, torch.float32),    # the cache's last slots
])
def test_fused_write_is_write_at_then_attention_bit_for_bit(
        tq, fill, q_dtype, kv_dtype, on_device):
    """The fused call against the port's ``KVCache.write_at`` (device
    position) or ``append_lockstep`` (host int) and then
    ``decode_attention``: outputs and written caches bit for bit, stale
    slots past the new rows untouched; :func:`attend_cache` the same, the
    host path advancing the cache's ``length``."""
    b, h, t, dh = 2, 3, 28, 64
    q, k, v = _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill, seed=tq)
    k_new, v_new = _new_rows(b, h, tq, dh, q_dtype, seed=fill + 3)
    pos = torch.tensor(fill) if on_device else fill
    ref = KVCache(k.clone(), v.clone(), fill)
    if on_device:
        ref.write_at(k_new, v_new, pos)
    else:
        ref.append_lockstep(k_new, v_new)
    want = decode_attention(q, ref.k, ref.v, pos)
    k1, v1 = k.clone(), v.clone()
    got = decode_attention(q, k1, v1, pos, k_new, v_new)
    assert torch.equal(got, want)
    assert torch.equal(k1, ref.k) and torch.equal(v1, ref.v)
    assert torch.equal(k1[..., fill + tq:, :], k[..., fill + tq:, :])
    cache = KVCache(k.clone(), v.clone(), fill)
    got = attend_cache(q, cache, k_new, v_new,
                       pos if on_device else None)
    assert torch.equal(got, want)
    assert torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)
    assert cache.length == (fill if on_device else fill + tq)


def test_attend_cache_raises_before_a_write_past_the_cache():
    q, k, v = _cache_case(1, 2, 4, 10, 32, torch.float32, torch.float32, 0,
                          seed=0)
    k_new, v_new = _new_rows(1, 2, 4, 32, torch.float32, seed=1)
    cache = KVCache(k, v, 7)
    with pytest.raises(ValueError, match="overflow"):
        attend_cache(q, cache, k_new, v_new)
    assert cache.length == 7
    with pytest.raises(ValueError, match="fill point"):
        decode_attention(q, k, v, None, k_new, v_new)


# -- (b3) the residual add taken into the norm -----------------------------

@pytest.mark.parametrize("x_dtype,d_dtype,p_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16),   # the TTS step's
], ids=["fp32", "bf16", "fp32-x-bf16-delta"])
@pytest.mark.parametrize("shape,delta_shape", [
    ((8, 1, 256), (8, 1, 256)),      # a decode step's residual
    ((3, 17, 96), (17, 96)),         # position rows over the batch
    ((2, 1, 64), (1, 64)),           # the TTS step's one position row
])
def test_add_layer_norm_matches_jax_and_the_unfused_pair(
        shape, delta_shape, x_dtype, d_dtype, p_dtype):
    """``add_layer_norm`` against JAX's ``x + delta`` then ``layer_norm``
    (``janus_tpu/ops/layers.py:46``): the sum bit-equal, the norm at
    ``layer_norm``'s bars; bit-equal to the port's add and ``layer_norm``."""
    x, scale, bias = _ln_inputs(shape, x_dtype, p_dtype, seed=shape[1])
    rng = np.random.default_rng(shape[-1])
    delta = torch.from_numpy(rng.standard_normal(delta_shape).astype(
        np.float32)).to(d_dtype)
    r, y = add_layer_norm(x, delta, scale, bias)
    jr = _j(x) + _j(delta)
    want = np.asarray(j_layer_norm(jr, _j(scale), _j(bias)), np.float32)
    assert r.dtype == x_dtype and r.shape == x.shape and y.dtype == x_dtype
    np.testing.assert_array_equal(_np(r), np.asarray(jr, np.float32))
    if x_dtype == torch.float32:
        np.testing.assert_allclose(_np(y), want, rtol=0, atol=1e-5)
    else:
        assert _bf16_ulps(_np(y), want).max() <= 1.0
    r2 = x + delta
    assert torch.equal(r, r2) and torch.equal(y, layer_norm(r2, scale, bias))


@pytest.mark.parametrize("shape,x_dtype,d_dtype,vec", [
    ((8, 1280), torch.bfloat16, torch.bfloat16, 8),   # the recognizer step
    ((8, 1280), torch.float32, torch.bfloat16, 4),    # the TTS step's
    ((5, 96), torch.float32, torch.float32, 4),       # the demo TTS width
])
def test_add_layer_norm_kernel_order_matches_plain(shape, x_dtype, d_dtype,
                                                   vec):
    """The kernel's residual: r = x + delta in fp32, rounded to x's dtype,
    then the norm's order of sums over r as stored: r bit-equal to the
    plain add, the norm within the layer norm's bars."""
    x, scale, bias = _ln_inputs(shape, x_dtype, torch.bfloat16, seed=5)
    delta = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)).to(d_dtype)
    r_ref, y_ref = add_layer_norm(x, delta, scale, bias)
    r = (_np(x) + _np(delta)).astype(np.float32)
    if x_dtype == torch.bfloat16:
        r = _round_bf16(r)
    np.testing.assert_array_equal(r, _np(r_ref))
    emu = layer_norm_emulated(r, _np(scale), _np(bias), vec=vec)
    if x_dtype == torch.float32:
        np.testing.assert_allclose(emu, _np(y_ref), rtol=0, atol=1e-5)
    else:
        assert _bf16_ulps(_round_bf16(emu), _np(y_ref)).max() <= 1.0


# -- (c) the route ---------------------------------------------------------

CUDA = torch.device("cuda")


@pytest.mark.parametrize("device,tq,t,dh,grad,dtypes,route", [
    (CUDA, 1, 25, 64, False, (torch.bfloat16, torch.bfloat16), "kernel"),
    (CUDA, 4, 500, 64, False, (torch.bfloat16, torch.bfloat16), "kernel"),
    (CUDA, 1, 1500, 64, False, (torch.bfloat16, torch.bfloat16), "kernel"),
    (CUDA, 1, 291, 64, False, (torch.float32, torch.bfloat16), "kernel"),
    (CUDA, 16, 48, 32, False, (torch.float32, torch.float32), "kernel"),
    (CUDA, 1, 77, 128, False, (torch.float32, torch.float32), "kernel"),
    (CUDA, 17, 48, 64, False, (torch.bfloat16, torch.bfloat16), "attend"),
    (CUDA, 35, 291, 64, False, (torch.bfloat16, torch.bfloat16), "attend"),
    (CUDA, 1, 25, 64, True, (torch.bfloat16, torch.bfloat16), "attend"),
    (CUDA, 1, 40, 48, False, (torch.float32, torch.bfloat16), "kernel"),
    (CUDA, 1, 25, 40, False, (torch.bfloat16, torch.bfloat16), "attend"),
    (CUDA, 1, 25, 64, False, (torch.float16, torch.float16), "attend"),
    (CUDA, 4, 200_000, 64, False, (torch.bfloat16, torch.bfloat16),
     "attend"),
    (torch.device("cpu"), 1, 25, 64, False,
     (torch.bfloat16, torch.bfloat16), "plain"),
])
def test_decode_route(device, tq, t, dh, grad, dtypes, route):
    assert decode_route(device, tq, t, dh, grad, dtypes) == route
    assert MAX_ROWS == 16


@pytest.mark.parametrize("t,kv_dtype,dh,splits", [
    (25, torch.bfloat16, 64, 1),
    (100, torch.bfloat16, 64, 1),
    (291, torch.bfloat16, 64, 4),
    (500, torch.bfloat16, 64, 4),
    (1500, torch.bfloat16, 64, 8),
    (48, torch.float32, 32, 1),
    (77, torch.float32, 128, 1),
    (40, torch.bfloat16, 48, 1),
    (300, torch.float32, 48, 4),
])
def test_tiles_and_splits(t, kv_dtype, dh, splits):
    """The host's plan: the splits (the fewest that leave a block at most
    128 of one row's keys, up to 8), and the scores a block then holds,
    well within the bound the kernel's shared memory is planned for."""
    assert plan_splits(t, kv_dtype, dh) == splits
    cap = -(-t // splits)
    assert cap <= 128 or splits == 8
    assert splits == 1 or -(-t // (splits // 2)) > 128
    assert score_bytes(t, 1, kv_dtype, dh) == 4 * cap <= SCORE_BYTES
    assert decode_route(CUDA, 1, t, dh, False, (kv_dtype, kv_dtype)) == (
        "kernel")


@pytest.mark.parametrize("t,one_row,four_rows", [
    (25, 1, 1), (291, 4, 2), (500, 4, 2), (1500, 8, 8)])
def test_split_plan_doubles_the_keys_of_four_row_blocks(t, one_row,
                                                        four_rows):
    """A block of 4 query rows takes twice a one-row block's keys before
    the plan splits (the 4-row prefill at T 500: 2 splits, 4 for one row),
    and holds the scores of its 4 rows."""
    assert plan_splits(t, torch.bfloat16, 64) == one_row
    assert plan_splits(t, torch.bfloat16, 64, tq=4) == four_rows
    for tq in (2, 4, 16):
        assert score_bytes(t, tq, torch.bfloat16, 64) == 16 * -(
            -t // four_rows)


@pytest.mark.parametrize("t,tq,kv_dtype,dh,route", [
    (8 * 40_960, 1, torch.bfloat16, 64, "kernel"),
    (8 * 40_960 + 1, 1, torch.bfloat16, 64, "attend"),
    (8 * 10_240, 4, torch.bfloat16, 64, "kernel"),
    (8 * 10_240 + 1, 16, torch.bfloat16, 64, "attend"),
    (40_000, 4, torch.float32, 128, "kernel"),   # the kernel's ring cycles
])
def test_route_holds_a_blocks_scores_within_the_bound(t, tq, kv_dtype, dh,
                                                      route):
    """The route's only shared-memory test: a block's scores within
    ``SCORE_BYTES`` (160 KB), for which the kernel always has a plan (its
    launcher asserts that at compile time); past 8 splits of 40,960 keys
    a row, or 10,240 for 4-row blocks, ``attend``."""
    assert SCORE_BYTES == 160 * 1024
    assert decode_route(CUDA, tq, t, dh, False, (kv_dtype, kv_dtype)) == route


# -- (d) the kernels' order of sums, emulated in numpy ----------------------

def _butterfly(a: np.ndarray, offsets) -> np.ndarray:
    """``__shfl_xor_sync`` sums over the last axis (every lane ends with
    the total, each summed in its own order; lane 0's is returned)."""
    lanes = np.arange(a.shape[-1])
    for o in offsets:
        a = (a + a[..., lanes ^ o]).astype(np.float32)
    return a[..., 0]


def _fma(a, b, c):
    """fp32 fused multiply-add: the fp32 product is exact in fp64."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def layer_norm_emulated(x: np.ndarray, scale, bias, eps=1e-5, vec=1):
    """csrc/layer_norm.cu's arithmetic in fp32: values held as chunks of
    ``vec`` by the lanes of a warp (d <= 2048) or a block of 8 warps, lane
    partial sums in order, shuffle trees, the warps' sums in order, the
    mean as the sum times fp32(1/d), rounded squares, one reciprocal root,
    three separately rounded operations."""
    rows, d = x.shape
    tpr = 32 if d <= 2048 else 256
    per = -(-d // (tpr * vec)) * vec           # values a lane holds
    padded = np.zeros((rows, per * tpr), np.float32)
    padded[:, :d] = x
    # value (lane + tpr j) vec + i lives in lane ``lane``, chunk j
    v = padded.reshape(rows, per // vec, tpr, vec)
    valid = (np.arange(per * tpr) < d).reshape(per // vec, tpr, vec)

    def row_sum(parts):                        # parts [rows, tpr]
        warps = parts.reshape(rows, tpr // 32, 32)
        total = _butterfly(warps, (16, 8, 4, 2, 1))
        s = np.zeros(rows, np.float32)
        for w in range(tpr // 32):
            s = (s + total[:, w]).astype(np.float32)
        return s

    inv_d = np.float32(1.0) / np.float32(d)
    s = np.zeros((rows, tpr), np.float32)
    for j in range(per // vec):
        for i in range(vec):
            s = (s + v[:, j, :, i]).astype(np.float32)
    mean = (row_sum(s) * inv_d).astype(np.float32)[:, None, None, None]
    c = (v - mean).astype(np.float32)
    sq = np.where(valid, (c * c).astype(np.float32), np.float32(0))
    q = np.zeros((rows, tpr), np.float32)
    for j in range(per // vec):
        for i in range(vec):
            q = (q + sq[:, j, :, i]).astype(np.float32)
    var = (row_sum(q) * inv_d).astype(np.float32)
    rstd = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float32)
                          .astype(np.float64))).astype(np.float32)
    n = (c * rstd[:, None, None, None]).astype(np.float32)
    y = n.reshape(rows, -1)[:, :d]
    y = (y * scale).astype(np.float32)
    return (y + bias).astype(np.float32)


@pytest.mark.parametrize("shape,x_dtype,p_dtype,vec", [
    ((8, 1280), torch.bfloat16, torch.bfloat16, 8),   # 40 values a lane
    ((8, 1280), torch.float32, torch.bfloat16, 4),    # the TTS step's
    ((5, 77), torch.float32, torch.float32, 1),
    ((3, 4096), torch.bfloat16, torch.float32, 8),    # a block a row
])
def test_layer_norm_kernel_order_matches_plain(shape, x_dtype, p_dtype, vec):
    x, scale, bias = _ln_inputs(shape, x_dtype, p_dtype, seed=3)
    ref = layer_norm_plain(x, scale, bias)
    emu = layer_norm_emulated(_np(x), _np(scale), _np(bias), vec=vec)
    if x_dtype == torch.float32:
        np.testing.assert_allclose(emu, _np(ref), rtol=0, atol=1e-5)
    else:
        assert _bf16_ulps(_round_bf16(emu), _np(ref)).max() <= 1.0


def split_ranges(n_read: int, splits: int):
    """The kernel's partition of the keys a query chunk reads: contiguous
    ranges of ceil(n_read / splits) keys, one a block of the cluster."""
    per = -(-n_read // splits)
    out = []
    for sp in range(splits):
        lo = min(n_read, sp * per)
        out.append((lo, min(n_read, lo + per)))
    return out


def decode_attention_emulated(q, k, v, pos, kv_bf16: bool, q_bf16: bool):
    """csrc/decode_attn.cu's arithmetic in fp32 over ``q[BH, tq, Dh]``,
    ``k, v[BH, T, Dh]`` (fp32 arrays of the tensors' values): chunks of 1
    or 4 query rows, each reading keys [0, n_read) cut into the cluster's
    contiguous split ranges; G lanes a key summing chunks of E values by
    FMA and a shuffle tree, scores times the scale; each block's max and
    its sum of exp(s - its max), thread t over local keys t, t + 128, ...,
    a shuffle tree and the warps in order; the cluster's m and l = sum l_s
    e^(m_s - m) in split order; p normalised and rounded to v's dtype; PV
    by FMA a lane over its keys (local key i to lane group i mod keys a
    pass, in order), a shuffle tree over the lanes of a column, the warps
    and the splits in order; one rounding to q's dtype."""
    bh, tq, dh = q.shape
    t = k.shape[1]
    kv_dtype = torch.bfloat16 if kv_bf16 else torch.float32
    e_n = 8 if kv_bf16 else 4
    g = lanes_per_position(kv_dtype, dh)   # lanes past dh / e_n idle
    ppp = keys_per_pass(kv_dtype, dh)
    dh_in, dh = dh, g * e_n
    q, k, v = (np.concatenate([a, np.zeros(a.shape[:-1] + (dh - dh_in,),
                                           np.float32)], -1)
               for a in (q, k, v))
    splits = plan_splits(t, kv_dtype, dh_in, tq)
    qb = 1 if tq == 1 else 4
    scale = np.float32(dh_in ** -0.5)
    out = np.zeros((bh, tq, dh), np.float32)
    tau = np.arange(t)
    for q0 in range(0, tq, qb):
        nq = min(qb, tq - q0)
        rows = np.arange(q0, q0 + nq)
        n_read = t if pos is None else min(t, pos + q0 + nq)
        last = (np.full(nq, t) if pos is None else pos + rows)
        # scores of every key: G partial dots of E values, a shuffle tree
        qc = q[:, rows].reshape(bh, nq, 1, g, e_n)
        kc = k.reshape(bh, 1, t, g, e_n)
        part = np.zeros((bh, nq, t, g), np.float32)
        for e in range(e_n):
            part = _fma(qc[..., e], kc[..., e], part)
        dot = _butterfly(part, [o for o in (16, 8, 4, 2, 1) if o < g])
        s = (dot * scale).astype(np.float32)
        seen = (tau[None, :] <= last[:, None]) & (tau[None, :] < n_read)
        s = np.where(seen[None], s, -np.inf).astype(np.float32)
        ranges = split_ranges(n_read, splits)
        parts = []
        for lo, hi in ranges:
            s_loc = s[..., lo:hi]
            m_s = (s_loc.max(axis=-1) if hi > lo
                   else np.full((bh, nq), -np.inf, np.float32))
            loc = np.zeros((bh, nq, -(-(hi - lo) // 128) * 128), np.float32)
            with np.errstate(invalid="ignore"):
                loc[..., :hi - lo] = np.where(
                    np.isfinite(m_s)[..., None],
                    np.exp(s_loc - m_s[..., None]), 0)
            thr = np.zeros((bh, nq, 128), np.float32)
            for i in range(loc.shape[-1] // 128):
                thr = (thr + loc[..., 128 * i:128 * (i + 1)]).astype(
                    np.float32)
            warp = _butterfly(thr.reshape(bh, nq, 4, 32), (16, 8, 4, 2, 1))
            blk = np.zeros((bh, nq), np.float32)
            for w in range(4):
                blk = (blk + warp[..., w]).astype(np.float32)
            parts.append((m_s.astype(np.float32), blk))
        m = np.max([m_s for m_s, _ in parts], axis=0)
        l_tot = np.zeros((bh, nq), np.float32)
        for m_s, l_s in parts:
            with np.errstate(invalid="ignore"):
                w_s = np.exp(m_s - m).astype(np.float32)
            l_tot = np.where(np.isfinite(m_s), _fma(l_s, w_s, l_tot), l_tot)
        e_ = np.where(seen[None], np.exp(s - m[..., None]), 0).astype(
            np.float32)
        p = (e_ / l_tot[..., None]).astype(np.float32)
        if kv_bf16:
            p = _round_bf16(p)
        # PV: lane group pp runs the local keys pp, pp + ppp, ... in order
        o_tot = np.zeros((bh, nq, dh), np.float32)
        for lo, hi in ranges:
            acc = np.zeros((bh, nq, ppp, g, e_n), np.float32)
            for kb in range(0, hi - lo, ppp):
                ts = lo + kb + np.arange(ppp)
                ok = ts < hi
                tsc = np.minimum(ts, t - 1)
                pj = np.where(ok, p[..., tsc], 0)[..., None, None]
                vj = v[:, tsc].reshape(bh, 1, ppp, g, e_n)
                acc = np.where(ok[None, None, :, None, None],
                               _fma(pj, vj, acc), acc)
            # lanes of one column in a warp: pp = w * (32 / g) + i
            per_warp = 32 // g
            acc = acc.reshape(bh, nq, 4, per_warp, g, e_n)
            acc = np.moveaxis(acc, 3, -1)
            offs = [o for o in (1, 2, 4, 8, 16) if o < per_warp]
            red = _butterfly(acc, offs)                  # [bh,nq,4,g,e]
            blk = np.zeros((bh, nq, g, e_n), np.float32)
            for w in range(4):
                blk = (blk + red[:, :, w]).astype(np.float32)
            o_tot = (o_tot + blk.reshape(bh, nq, dh)).astype(np.float32)
        out[:, rows] = o_tot
    out = out[..., :dh_in]
    return _round_bf16(out) if q_bf16 else out


@pytest.mark.parametrize("tq,t,dh,q_dtype,kv_dtype,fill", [
    (1, 25, 64, torch.bfloat16, torch.bfloat16, 9),     # self, one tile
    (4, 28, 64, torch.bfloat16, torch.bfloat16, 0),     # prefill rows
    (1, 500, 64, torch.bfloat16, torch.bfloat16, None),  # cross, 2 splits
    (4, 300, 64, torch.bfloat16, torch.bfloat16, None),  # cross, ragged
    (1, 291, 64, torch.float32, torch.bfloat16, 135),   # the TTS step
    (3, 77, 128, torch.float32, torch.float32, 60),     # fp32, 32-lane rows
    (2, 200, 32, torch.float32, torch.float32, None),   # Dh 32
    (1, 40, 48, torch.float32, torch.bfloat16, 17),     # the demo TTS step
    (1, 1500, 64, torch.bfloat16, torch.bfloat16, None),  # 30 s, 8 splits
    (1, 1500, 64, torch.bfloat16, torch.bfloat16, 4),   # splits left empty
    (16, 200, 128, torch.bfloat16, torch.float32, 100),  # 4 query chunks
])
def test_decode_attention_kernel_order_matches_plain(tq, t, dh, q_dtype,
                                                     kv_dtype, fill):
    b, h = 2, 2
    q, k, v = _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill or 0,
                          seed=t + tq)
    ref = decode_attention_plain(q, k, v, fill)
    emu = decode_attention_emulated(
        _np(q).reshape(b * h, tq, dh), _np(k).reshape(b * h, t, dh),
        _np(v).reshape(b * h, t, dh), fill, kv_dtype == torch.bfloat16,
        q_dtype == torch.bfloat16).reshape(b, h, tq, dh)
    rtol, atol = BF16_BAR if torch.bfloat16 in (q_dtype, kv_dtype) \
        else FP32_BAR
    assert np.isfinite(emu).all()
    assert _ratio(emu, _np(ref), rtol, atol) <= 1.0


@pytest.mark.parametrize("tq,t,fill,q_dtype,kv_dtype", [
    (1, 25, 12, torch.bfloat16, torch.bfloat16),    # the recognizer step
    (4, 28, 0, torch.bfloat16, torch.bfloat16),     # the prompt-4 prefill
    (1, 291, 163, torch.float32, torch.bfloat16),   # the TTS step
])
def test_fused_write_kernel_order_matches_plain(tq, t, fill, q_dtype,
                                                kv_dtype):
    """The fused call's arithmetic: the new rows rounded into the cache,
    then the kernel's order of sums over the written cache, against the
    plain fused call (which writes the same cache)."""
    b, h, dh = 2, 2, 64
    q, k, v = _cache_case(b, h, tq, t, dh, q_dtype, kv_dtype, fill, seed=t)
    k_new, v_new = _new_rows(b, h, tq, dh, q_dtype, seed=t + 1)
    ref = decode_attention_plain(q, k, v, fill, k_new, v_new)
    assert torch.equal(k[..., fill:fill + tq, :], k_new.to(kv_dtype))
    emu = decode_attention_emulated(
        _np(q).reshape(b * h, tq, dh), _np(k).reshape(b * h, t, dh),
        _np(v).reshape(b * h, t, dh), fill, kv_dtype == torch.bfloat16,
        q_dtype == torch.bfloat16).reshape(b, h, tq, dh)
    assert _ratio(emu, _np(ref), *BF16_BAR) <= 1.0


@pytest.mark.parametrize("n_read,splits", [(500, 4), (5, 8), (1500, 8),
                                           (1, 2), (163, 4)])
def test_split_ranges_cover_the_keys_read_once(n_read, splits):
    """The cluster's blocks take contiguous ranges that cover [0, n_read)
    once, the first ones full (so a new row's slot has one owner)."""
    ranges = split_ranges(n_read, splits)
    assert len(ranges) == splits and ranges[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert ranges[-1][1] == n_read
    assert max(hi - lo for lo, hi in ranges) == -(-n_read // splits)


# -- (e) the recognizer head widened once ----------------------------------

def test_recognizer_head_widened_once_is_bit_equal():
    """The captured greedy step's fp32 head, made once for the tree, gives
    the eager loop's tokens (whose step widens the table every call)."""
    from janus_tpu_torch.common.config import ASRConfig
    from janus_tpu_torch.models.asr import (_greedy_graphed, encode_audio,
                                            greedy_decode)
    from janus_tpu_torch.models.params import (cast_floating, init_asr,
                                               prepare_decode_params)
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg = ASRConfig(n_mels=16, d_model=64, encoder_layers=1,
                    decoder_layers=2, num_heads=2, vocab_size=261,
                    max_source_positions=16, max_target_positions=16,
                    max_decode_tokens=6)
    params = prepare_decode_params(cast_floating(init_asr(
        torch.Generator().manual_seed(0), cfg), torch.bfloat16))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 16)).astype(np.float32)).to(torch.bfloat16)
    enc = encode_audio(params, cfg, mel)
    prompt = torch.full((2, 1), 256, dtype=torch.long)
    graphs = StepGraphs()
    got = _greedy_graphed(params, cfg, enc, prompt, 257, 6, torch.bfloat16,
                          False, graphs)
    want = greedy_decode(params, cfg, enc, prompt, 257, max_new=6,
                         cache_dtype=torch.bfloat16, eager=True)
    assert torch.equal(got, want)
    head = graphs.derived("asr_head_fp32", None)
    assert head.dtype == torch.float32
    assert torch.equal(head, params["decoder"]["token_emb"].float())
