"""What the CPU can hold of the mixed-dtype linear (``csrc/mixed_linear.cu``,
``ops/mixed_linear.py``): fp32 rows against bf16 weights, as the TTS's AR
step multiplies its fp32 mel re-entry through bf16 parameters. The plain
version against the JAX package's ``linear`` at the step's shapes (small
width), bit-equal to the per-call promotion ``linear`` ran before it; the
route and the split plan; the autograd function's gradient; a numpy
emulation of the kernel's order of sums against the plain version at the
card's bar, and a generation run through that emulation against the JAX
package; the grouped launch (q/k/v, the two heads) and fc1's GELU
epilogue: their plain routes are the separate calls bit for bit, their
plan, and their emulation at the card's bar; the AR step over the bf16
tree itself (no widened copy) with the captured step's path bit-equal to
the eager loop. The kernel runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.ops.layers import linear as j_linear
from janus_tpu_torch.ops import layers as t_layers
from janus_tpu_torch.ops import mixed_linear as ml
from janus_tpu_torch.ops.mixed_linear import (MAX_ROWS, mixed_linear,
                                              mixed_linear_group,
                                              mixed_linear_plain,
                                              mixed_route, plan_group,
                                              plan_rows, plan_splits,
                                              use_pdl)

# the AR step's linears at small width (d 64; flagship d 1280): the prenet
# (r mels -> d, d -> d), q/k/v/out (d -> d), fc1 (d -> 4d), fc2 (4d -> d),
# the mel head (d -> r mels) and the stop head (d -> 1)
D = 64
STEP_SHAPES = [(32, D), (D, D), (D, 4 * D), (4 * D, D), (D, 32), (D, 1)]


def row_groups(m, rows):
    """The kernel's groups of ``rows`` rows holding ``m`` rows (a power of
    two, at most 8)."""
    return 1 << (-(-m // rows) - 1).bit_length()


def _case(m, k, n, bias="bfloat16", seed=0):
    """fp32 rows, a bf16 weight and a bias (bf16, fp32 or none) from a
    numpy seed, as float32 numpy arrays and as the port's tensors."""
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((m, k))).astype(np.float32)
    w = torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(
        np.float32)).to(torch.bfloat16)
    b = None if bias is None else torch.from_numpy(
        (0.1 * rng.standard_normal(n)).astype(np.float32)).to(
            getattr(torch, bias))
    return torch.from_numpy(x), w, b


def _bar(x, w, b, scale):
    """``scale * (sum_k |x_k w_kn| + |b_n|)`` elementwise, in float64."""
    mag = np.abs(x.double().numpy()) @ np.abs(w.double().numpy())
    if b is not None:
        mag = mag + np.abs(b.double().numpy())
    return scale * mag


def _old_branch(x, w, b):
    """``linear``'s mixed-dtype branch as it stood before the kernel."""
    ct = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    y = (torch.matmul(x2, w.to(ct)) if b is None
         else torch.addmm(b.to(ct), x2, w.to(ct)))
    return y.to(x.dtype).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


@pytest.mark.parametrize("bias", ["bfloat16", "float32", None])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", STEP_SHAPES)
def test_plain_follows_jax_linear(k, n, m, bias):
    """The same exact products, summed in another order: within 1e-6 of
    ``sum_k |x_k w_kn| + |b_n|``."""
    x, w, b = _case(m, k, n, bias, seed=k + n + m)
    got = mixed_linear_plain(x, w, b)
    jb = None if b is None else jnp.asarray(b.float().numpy()).astype(
        jnp.bfloat16 if bias == "bfloat16" else jnp.float32)
    ref = np.asarray(j_linear(jnp.asarray(x.numpy()),
                              jnp.asarray(w.float().numpy()).astype(
                                  jnp.bfloat16), jb))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.all(np.abs(got.numpy() - ref) <= _bar(x, w, b, 1e-6))


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float64, torch.float32), (torch.float32, torch.float16)])
@pytest.mark.parametrize("m", [1, 8, 65])
def test_plain_is_the_old_branch_bit_for_bit(x_dtype, w_dtype, m):
    """On the CPU ``linear`` (through the route and ``mixed_linear``) and
    the plain version give the promotion ``linear`` ran before, bit for
    bit, over leading axes and with and without a bias."""
    x, w, b = _case(m, D, 3 * D, "float32", seed=m)
    x = x.to(x_dtype).reshape(1, m, D)
    w, b = w.to(w_dtype), b.to(w_dtype)
    for bias in (b, None):
        want = _old_branch(x, w, bias)
        assert torch.equal(mixed_linear_plain(x, w, bias), want)
        assert torch.equal(mixed_linear(x, w, bias), want)
        assert torch.equal(t_layers.linear(x, w, bias), want)


@pytest.mark.parametrize("rows,want", [(1, "kernel"), (8, "kernel"),
                                       (16, "kernel"), (64, "kernel"),
                                       (65, "widen"), (0, "widen")])
def test_route_by_rows(rows, want):
    assert mixed_route(torch.float32, torch.bfloat16, rows) == want


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float16),
    (torch.float64, torch.bfloat16), (torch.float16, torch.bfloat16)])
def test_route_by_dtypes_and_layout(x_dtype, w_dtype):
    assert mixed_route(x_dtype, w_dtype, 8) == "widen"
    assert mixed_route(torch.float32, torch.bfloat16, 8,
                       n_contiguous=False) == "widen"


@pytest.mark.parametrize("m,k,n,sms,want", [
    (8, 1280, 1280, 132, 8), (8, 5120, 1280, 132, 8),
    (8, 1280, 5120, 132, 2), (1, 1280, 1, 132, 8), (8, 320, 1280, 132, 4),
    (8, 1280, 320, 132, 8), (16, 1280, 1280, 132, 8),
    (64, 5120, 1280, 132, 8), (8, 1280, 1280, 8, 1),
    (8, 1280, 1280, 40, 2), (8, 128, 64, 132, 2), (8, 127, 64, 132, 1),
    (8, 8, 64, 132, 1), (8, 1280, 64 * 600, 132, 1),
    (65, 1280, 1280, 132, 0), (0, 1280, 1280, 132, 0)])
def test_plan_splits(m, k, n, sms, want):
    """The fewest blocks a tile for a block on every SM, each split at
    least 64 k-rows (the AR step's: 8 at 1280 columns and the 320-wide
    head, 2 at fc1, 4 at the prenet's K of 320); none outside the kernel's
    rows."""
    assert plan_splits(m, k, n, sms) == want


@pytest.mark.parametrize("m,rows,groups", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (8, 4, 2), (16, 4, 4), (17, 4, 8),
    (32, 4, 8), (33, 8, 8), (64, 8, 8)])
def test_plan_rows(m, rows, groups):
    """Rows a group and the groups (at most 8) that hold ``m`` rows."""
    assert plan_rows(m) == rows and row_groups(m, rows) == groups
    assert rows * groups >= m and groups <= 8


def test_the_kernel_route_raises_off_its_inputs():
    """The launcher never runs on a CPU tensor and raises on operands the
    kernel does not take (no fallback)."""
    x, w, b = _case(8, D, D)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ml._launch(x, w, b)


@pytest.mark.parametrize("bias", ["bfloat16", None])
def test_autograd_function_gradient_is_the_plain_one(monkeypatch, bias):
    """``_MixedLinear``'s backward is the plain product's gradient (its
    forward, the kernel, stood in for by the plain version here)."""
    monkeypatch.setattr(ml, "_launch",
                        lambda x, w, b: mixed_linear_plain(x, w, b))
    x, w, b = _case(4, D, 2 * D, bias, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 2 * D)).astype(np.float32))
    leaves = [t for t in (x, w, b) if t is not None]

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in leaves]
        y = fn(ins[0], ins[1], ins[2] if len(ins) > 2 else None)
        return torch.autograd.grad(y, ins, g)

    got = grads(ml._MixedLinear.apply)
    want = grads(mixed_linear_plain)
    assert len(got) == len(leaves)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


# -- one launch for several weights, and fc1's GELU --------------------------

# q/k/v (k without a bias) and the two heads at small width
GROUPS = {"qkv": [(D, D, "bfloat16"), (D, D, None), (D, D, "bfloat16")],
          "heads": [(D, 32, "bfloat16"), (D, 1, "bfloat16")]}


def _members(kind, seed):
    out = []
    for i, (k, n, bias) in enumerate(GROUPS[kind]):
        _, w, b = _case(1, k, n, bias, seed=seed + i)
        out.append((w, b))
    return out


@pytest.mark.parametrize("kind", sorted(GROUPS))
@pytest.mark.parametrize("m", [1, 8])
def test_group_and_gelu_plain_routes_are_the_separate_calls(kind, m):
    """On the CPU the grouped entry is the separate plain calls and the
    GELU option is ``gelu`` of the plain call, bit for bit, through
    ``ops/mixed_linear.py`` and through ``linear_group`` /
    ``linear_gelu``."""
    x, _, _ = _case(m, D, 1, None, seed=m)
    x = x.reshape(1, m, D)
    members = _members(kind, seed=10 * m)
    want = [mixed_linear_plain(x, w, b) for w, b in members]
    for got in (mixed_linear_group(x, members),
                t_layers.linear_group(x, members)):
        assert len(got) == len(want)
        for g, c in zip(got, want):
            assert g.shape == c.shape and torch.equal(g, c)
    for w, b in members:
        want = t_layers.gelu(mixed_linear_plain(x, w, b))
        assert torch.equal(mixed_linear(x, w, b, gelu=True), want)
        assert torch.equal(mixed_linear_plain(x, w, b, gelu=True), want)
        assert torch.equal(t_layers.linear_gelu(x, w, b),
                           t_layers.gelu(t_layers.linear(x, w, b)))


def test_group_of_other_dtypes_is_one_linear_a_member():
    """Where the route does not name the kernel for every member (same
    dtypes, as the prefill's bf16 x bf16), ``linear_group`` is the
    separate ``linear`` calls."""
    x, w, b = _case(8, D, D, "float32", seed=1)
    members = [(w.float(), b), (w.float(), None)]
    got = t_layers.linear_group(x, members)
    for g, (ww, bb) in zip(got, members):
        assert torch.equal(g, t_layers.linear(x, ww, bb))


@pytest.mark.parametrize("m,k,ns,sms,tile0,tiles,splits,rows", [
    (8, 1280, [1280] * 3, 132, (0, 20, 40), 60, 4, 4),
    (1, 1280, [1280] * 3, 132, (0, 20, 40), 60, 4, 1),
    (8, 1280, [320, 1], 132, (0, 5), 6, 8, 4),
    (1, 1280, [320, 1], 132, (0, 5), 6, 8, 1),
    (8, 1280, [5120], 132, (0,), 80, 2, 4),
    (8, 320, [1280], 132, (0,), 20, 4, 4),
    (8, 5120, [1280], 132, (0,), 20, 8, 4),
    (16, 1280, [100, 28, 64], 132, (0, 2, 3), 4, 8, 4),
    (8, 64, [64] * 3, 132, (0, 1, 2), 3, 1, 4),
    (8, 1280, [1280] * 3, 40, (0, 20, 40), 60, 1, 4),
    (65, 1280, [1280] * 3, 132, (0, 20, 40), 60, 0, 8)])
def test_plan_group(m, k, ns, sms, tile0, tiles, splits, rows):
    """Each member's tiles one after another (a narrow member a tile of
    its own), the splits of ``plan_splits`` over all the tiles (4 for the
    step's q/k/v, 8 for its heads) and the rows of ``plan_rows``; one
    member plans as ``plan_splits``."""
    plan = plan_group(m, k, ns, sms)
    assert plan == (tile0, tiles, splits, rows)
    if len(ns) == 1:
        assert plan.splits == plan_splits(m, k, ns[0], sms)


def test_use_pdl_at_every_row_count_the_kernel_takes():
    assert all(use_pdl(m) for m in (1, 8, 16, 64))
    assert not use_pdl(0) and not use_pdl(MAX_ROWS + 1)


# -- the kernel's order of sums, emulated -----------------------------------

def emulate(x, w, b=None, splits=None, rows=None, gelu=False):
    """The kernel's arithmetic in numpy: each split's range of K (starting
    on multiples of 8), each k-lane's fused multiply-adds over its k-rows
    in increasing order (32 / row groups k-lanes), the four k-lanes of a
    warp as (0 + 1) + (2 + 3), the warps in order, the splits in order,
    then the bias, all in float32, then with ``gelu`` the exact GELU. A
    fused multiply-add is emulated in float64 (the product exact, the sum
    rounded twice: within an ulp of the card's)."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).numpy().astype(np.float64)
    wd = w.float().numpy().astype(np.float64)
    m, k = x2.shape
    n = wd.shape[1]
    if splits is None:
        splits = plan_splits(m, k, n)
    kl = 32 // row_groups(m, plan_rows(m) if rows is None else rows)
    units = -(-k // 8)
    total = None
    for s in range(splits):
        k0 = units * s // splits * 8
        k1 = min(k, units * (s + 1) // splits * 8)
        length = k1 - k0
        j = -(-length // kl)
        xs = np.zeros((m, j * kl))
        ws = np.zeros((j * kl, n))
        xs[:, :length] = x2[:, k0:k1]
        ws[:length] = wd[k0:k1]
        xs = xs.reshape(m, j, kl)
        ws = ws.reshape(j, kl, n)
        acc = np.zeros((kl, m, n), np.float32)
        for jj in range(j):
            prod = xs[:, jj, :].T[:, :, None] * ws[jj][:, None, :]
            acc = (prod + acc.astype(np.float64)).astype(np.float32)
        quads = [(acc[4 * q] + acc[4 * q + 1]) + (acc[4 * q + 2]
                                                  + acc[4 * q + 3])
                 for q in range(kl // 4)]
        block = quads[0]
        for q in quads[1:]:
            block = block + q
        total = block if total is None else total + block
    if b is not None:
        total = total + b.float().numpy()
    y = torch.from_numpy(total.reshape(lead + (n,)))
    return t_layers.gelu(y) if gelu else y


def emulate_group(x, members, gelu=False):
    """One grouped launch emulated: every member at the group's splits and
    rows (:func:`plan_group` over all members' columns)."""
    m = x.numel() // x.shape[-1]
    plan = plan_group(m, x.shape[-1], [w.shape[1] for w, _ in members])
    return [emulate(x, w, b, plan.splits, plan.rows, gelu)
            for w, b in members]


@pytest.mark.parametrize("m", [1, 8, 16, 64])
@pytest.mark.parametrize("k,n", STEP_SHAPES + [(1280, 320), (320, 64)])
def test_emulated_kernel_sums_hold_the_card_bar(k, n, m):
    """The kernel's order of sums at its own split plan and at every
    other: within the card's bar of the plain version, 1e-5 (sum |x w| +
    |b|), and the same bits on every run."""
    x, w, b = _case(m, k, n, "bfloat16", seed=2 * k + n + m)
    ref = mixed_linear_plain(x, w, b)
    bar = _bar(x, w, b, 1e-5)
    first = emulate(x, w, b)
    assert torch.equal(first, emulate(x, w, b))
    for splits in (1, 2, 4, 8):
        if splits <= -(-k // 8):
            got = emulate(x, w, b, splits)
            assert np.all(np.abs((got - ref).numpy()) <= bar), splits
    for rows in (1, 2, 4, 8):
        if 8 * rows >= m:
            got = emulate(x, w, b, rows=rows)
            assert np.all(np.abs((got - ref).numpy()) <= bar), rows


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("kind", sorted(GROUPS))
def test_emulated_group_and_gelu_hold_the_card_bar(kind, m):
    """A grouped launch at its plan (the group's splits, not each
    member's), and fc1 with the GELU in its epilogue: within 1e-5 (sum |x
    w| + |b|) of the separate plain calls and of ``gelu`` of the plain
    call."""
    x, _, _ = _case(m, D, 1, None, seed=3 * m)
    members = _members(kind, seed=m)
    for got, (w, b) in zip(emulate_group(x, members), members):
        ref = mixed_linear_plain(x, w, b)
        assert np.all(np.abs((got - ref).numpy()) <= _bar(x, w, b, 1e-5))
    x, w, b = _case(m, D, 4 * D, "bfloat16", seed=m + 1)
    got = emulate(x, w, b, gelu=True)
    ref = t_layers.gelu(mixed_linear_plain(x, w, b))
    assert np.all(np.abs((got - ref).numpy()) <= _bar(x, w, b, 1e-5))


def _tts_cfgs(dtype="bfloat16"):
    from janus_tpu.common.config import TTSConfig as JTTSConfig
    from janus_tpu_torch.common.config import TTSConfig

    kw = dict(d_model=D, layers=2, num_heads=4, n_mels=16, reduction=2,
              max_text_tokens=32, max_mel_frames=32)
    return JTTSConfig(**kw), TTSConfig(**kw, dtype=dtype)


def test_generation_through_the_emulated_kernel_follows_jax(monkeypatch):
    """bf16 parameters, every mixed linear of the AR steps (and the
    speaker projection) computed in the kernel's order of sums, grouped
    as the card launches them and with fc1's GELU in the epilogue: the JAX
    package's bar for bf16 weights (1e-2, ``tests/test_torch_tts.py``),
    equal ``n_frames``. (The port's seeded weights, handed to JAX; its
    loop jitted, ~2 s against ~5 s eager.)"""
    import jax

    from janus_tpu.models import tts as j_tts
    from janus_tpu_torch.models import tts as t_tts
    from janus_tpu_torch.models.params import cast_floating, params_to_jax

    jc, tc = _tts_cfgs()
    tp = t_tts.init_tts(torch.Generator().manual_seed(0), tc, text_vocab=261)
    tp16 = cast_floating(tp, torch.bfloat16)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                        params_to_jax(tp))
    rng = np.random.default_rng(5)
    text = rng.integers(0, 256, size=(2, 8)).astype(np.int32)
    emo = rng.integers(0, 12, size=(2,)).astype(np.int32)
    spk = rng.standard_normal((2, D)).astype(np.float32)
    calls = []

    def kernel_order(x, w, b=None, gelu=False):
        calls.append(tuple(x.shape))
        return emulate(x, w, b, gelu=gelu)

    def group_order(x, members):
        calls.append(tuple(x.shape))
        return emulate_group(x, members)

    monkeypatch.setattr(t_layers, "mixed_linear", kernel_order)
    monkeypatch.setattr(t_layers, "mixed_linear_group", group_order)
    mel, n = t_tts.tts_generate(
        tp16, tc, torch.from_numpy(text), torch.from_numpy(emo),
        speaker=torch.from_numpy(spk), max_groups=8, stop_threshold=2.0)
    generate = jax.jit(j_tts.tts_generate, static_argnums=(1,),
                       static_argnames=("max_groups", "stop_threshold"))
    ref_mel, ref_n = generate(
        jp16, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), max_groups=8, stop_threshold=2.0)
    # the speaker projection, then 7 steps of 2 x 4 + 3 launches: the
    # prenet's two (fc1 with its GELU), q/k/v in one, out, fc1 with its
    # GELU and fc2 a layer, the two heads in one
    assert len(calls) == 1 + 7 * (4 * tc.layers + 3)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=0,
                               atol=1e-2)


# -- the AR step over the bf16 tree itself ----------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_graph_step_over_the_bf16_tree_equals_the_eager_loop(cache_dtype):
    """The holder's step runs over the tree it was given (no widened copy
    kept beside it: the graphs derive nothing for the TTS) and gives the
    eager loop's groups and ``n_frames`` bit for bit, whole and in
    chunks."""
    from janus_tpu_torch.models import tts as t_tts
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tts import init_tts
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    _, cfg = _tts_cfgs(cache_dtype)
    params = cast_floating(init_tts(torch.Generator().manual_seed(0), cfg),
                           torch.bfloat16)
    rng = np.random.default_rng(2)
    text = torch.from_numpy(rng.integers(0, 256, (3, 8)))
    emo = torch.tensor([1, 4, 0])
    graphs = StepGraphs()
    eager = t_tts.tts_generate(params, cfg, text, emo, max_groups=6,
                               stop_threshold=2.0, eager=True)
    graphed = t_tts._generate_graphed(params, cfg, text, emo, None, 6, 261,
                                      2.0, graphs)
    assert torch.equal(graphed[0], eager[0])
    assert torch.equal(graphed[1], eager[1])
    holder = next(iter(graphs._holders.values()))
    assert holder.params is params and graphs._derived == {}
    assert not hasattr(holder, "step_params")
    # chunks from a holder's prefill against the eager chunks
    *a, gs = t_tts._prefill_graphed(params, cfg, text, emo, None, 6, 261,
                                    2.0, graphs)
    *b, es = t_tts.tts_prefill(params, cfg, text, emo, max_groups=6,
                               stop_threshold=2.0, eager=True)
    for lo, steps in ((0, 3), (3, 2)):
        got = t_tts.tts_decode_chunk(params, cfg, gs, *a, lo, steps, 2.0)
        want = t_tts.tts_decode_chunk(params, cfg, es, *b, lo, steps, 2.0)
        for p, q in zip(got[:4], want[:4]):
            assert torch.equal(p, q)
        a, b = got[2:4], want[2:4]
    assert MAX_ROWS == 64


def test_trace_step_timeline_gaps_and_span():
    """``tools/trace_step.py`` on a hand-made trace: kernels in order of
    start with the gap before each (negative where a programmatic launch
    overlapped the kernel before), summed by the kinds of a kernel and the
    one before it, and the union of the intervals beside their sum."""
    from janus_tpu_torch.tools.trace_step import (gaps_by_kind, kernel_rows,
                                                  kind_of, span_us, timeline)

    events = [("void layer_norm_kernel<float>", 100.0, 3.0),
              ("void (anonymous namespace)::mixed_linear<4, 2>", 101.0, 8.0),
              ("decode_attn_kernel<float>", 112.0, 5.0),
              ("void (anonymous namespace)::mixed_linear<4, 2>", 116.0, 8.0),
              ("GeluCUDAKernelImpl", 130.0, 1.0)]
    trace = {"traceEvents": [{"cat": "cpu_op", "name": "aten::mm",
                              "ts": 0.0, "dur": 500.0}]
             + [{"cat": "kernel", "name": n, "ts": t, "dur": d}
                for n, t, d in reversed(events)]}
    rows = timeline(trace)
    assert [r["kind"] for r in rows] == ["norm", "mixed linear", "attention",
                                         "mixed linear", "gelu"]
    assert [r["gap_us"] for r in rows] == [None, -2.0, 3.0, -1.0, 6.0]
    pairs = gaps_by_kind(rows)
    assert pairs["mixed linear after norm"] == {
        "count": 1, "mean_us": 8.0, "mean_gap_us": -2.0, "min_gap_us": -2.0,
        "max_gap_us": -2.0}
    assert sum(p["count"] for p in pairs.values()) == len(rows) - 1
    assert span_us(rows) == 9.0 + 12.0 + 1.0
    assert sum(r["total_us"] for r in kernel_rows(trace)) == 25.0
    assert kind_of("ampere_sgemm_64x32") == "other"
