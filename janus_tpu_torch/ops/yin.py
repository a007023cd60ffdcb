"""YIN fundamental-frequency tracking over a whole signal at once.

The port of the JAX package's ``janus_tpu/ops/yin.py``. Where ``hop``
divides ``buf // 2`` (the serving geometries 1360/170 and 4096/512 both
do), every hop window's difference function d(τ) is built signal-level
(:func:`_track_difference`) by one of two routes:

- ``"kernel"`` (the default): hop-aligned block sums (:mod:`.yin_blocksums`:
  the CUDA kernel on the card, its plain version on the CPU), block-prefix
  differences for the cross term and prefix-sum differences for the window
  energies;
- ``"dft"``: the JAX package's matmul-DFT route, plain fp32 matmuls (one
  forward DFT a hop block, shift-theorem span assembly, one inverse
  matmul onto the lag axis); no kernel.

Any other geometry takes the per-window FFT fallback (:func:`yin_frame`
over :func:`_hop_windows`). Then the cumulative-mean normalisation,
aubio's first-dip selection and quadratic refinement.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from janus_tpu_torch.ops.yin_blocksums import block_sums

__all__ = [
    "yin_frame",
    "yin_track",
    "mean_voiced_pitch",
    "classify_pitch",
    "PITCH_TAGS",
    "pitch_tag",
]

PITCH_TAGS = ("Deep", "Normal", "High")


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, dim=-1)``, the same bits on every run. PyTorch
    scans a tensor that is one row (numel == the scanned size) on CUDA
    with CUB's single-pass scan, whose float sums follow the blocks'
    timing (a one-phrase encode's f0 moved in its last bits from run to
    run); beside a zero row it takes the row-wise scan, each row's sums
    in a fixed order. On the CPU the rows are scanned alike."""
    if x.numel() != x.shape[-1]:
        return torch.cumsum(x, dim=-1)
    return torch.cumsum(torch.stack([x, torch.zeros_like(x)]), dim=-1)[0]


def _cmndf(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference: y[0]=1,
    y[τ] = d[τ]·τ / Σ_{k=1..τ} d[k] (1 where the running sum is 0)."""
    tau = torch.arange(d.shape[-1], dtype=d.dtype, device=d.device)
    running = _cumsum(d) - d[..., :1]  # excludes τ=0
    y = torch.where(running > 0.0,
                    d * tau / torch.clamp_min(running, 1e-30),
                    torch.ones_like(d))
    y[..., 0] = 1.0
    return y


def _quadratic_interp(y: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Parabola through (pos-1, pos, pos+1); pos unchanged at the edges."""
    n = y.shape[-1]
    p = pos.clamp(1, n - 2)
    s0 = torch.gather(y, -1, (p - 1)[..., None])[..., 0]
    s1 = torch.gather(y, -1, p[..., None])[..., 0]
    s2 = torch.gather(y, -1, (p + 1)[..., None])[..., 0]
    denom = s0 - 2.0 * s1 + s2
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (s0 - s2) / denom,
                        torch.zeros_like(denom))
    interp = p.to(y.dtype) + delta
    at_edge = (pos <= 0) | (pos >= n - 1)
    return torch.where(at_edge, pos.to(y.dtype), interp)


def _search_bounds(buf: int, sample_rate: int,
                   fmin: float | None, fmax: float | None):
    """(p_lo, p_hi, n_lags_out, bounded) for a window length and F0 range."""
    n_lags = buf // 2
    p_lo = 2 if fmax is None else max(2, int(sample_rate / fmax))
    p_hi = n_lags - 4 if fmin is None else min(n_lags - 4,
                                               int(sample_rate / fmin))
    # only y[0 .. p_hi+1] is ever inspected (the local-min test reads y[p+1])
    n_lags_out = n_lags if fmin is None else min(n_lags, p_hi + 2)
    return p_lo, p_hi, n_lags_out, fmin is not None or fmax is not None


def _select_pitch(y: torch.Tensor, sample_rate: int, tolerance: float,
                  p_lo: int, p_hi: int, bounded: bool) -> torch.Tensor:
    """CMNDF ``y[..., n_lags_out]`` → F0 in Hz (0 = unvoiced)."""
    n_lags_out = y.shape[-1]
    p_idx = torch.arange(n_lags_out, device=y.device)
    in_range = (p_idx >= p_lo) & (p_idx <= p_hi)
    cand = in_range & (y < tolerance) & (y < torch.roll(y, -1, dims=-1))
    if bounded:
        # a clipped range can start mid-rising-slope: require a genuine
        # two-sided local minimum
        cand = cand & (y <= torch.roll(y, 1, dims=-1))
    has_cand = cand.any(dim=-1)
    first = torch.argmax(cand.to(torch.int8), dim=-1)
    if not bounded:
        fallback = torch.argmin(y, dim=-1)
    else:
        fallback = torch.argmin(
            torch.where(in_range, y, torch.full_like(y, float("inf"))),
            dim=-1)
    pos = torch.where(has_cand, first, fallback)

    period = _quadratic_interp(y, pos)
    pitch = torch.where(period > 0.0,
                        sample_rate / torch.clamp_min(period, 1e-6),
                        torch.zeros_like(period))
    if bounded:
        pitch = torch.where(has_cand, pitch, torch.zeros_like(pitch))
    return pitch


def _fast_fft_len(n: int) -> int:
    """Smallest 5-smooth (2^a·3^b·5^c) length ≥ n."""
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p = p3
            while p < n:
                p *= 2
            best = min(best, p)
            p3 *= 3
        p5 *= 5
    return best


def _difference_function(x: torch.Tensor, n_lags: int,
                         n_lags_out: int | None = None) -> torch.Tensor:
    """d(τ) = Σ_{j<N} (x[j] - x[j+τ])², τ ∈ [0, n_lags_out), summing over
    N = n_lags terms, for windows x ``[..., 2·n_lags]``.

    d(τ) = Σ x[j]² + Σ x[j+τ]² − 2·Σ x[j]x[j+τ]: the cross term is an FFT
    correlation, the sliding energy a prefix-sum difference. A bounded
    search (``n_lags_out`` < n_lags) shrinks the FFT: linear correlation
    for lags < L is exact whenever the length is ≥ buf + L."""
    buf = x.shape[-1]
    if n_lags_out is None:
        n_lags_out = n_lags
    a = x[..., :n_lags]
    csum0 = F.pad(_cumsum(x * x), (1, 0))
    tau = torch.arange(n_lags_out, device=x.device)
    energy = csum0[..., tau + n_lags] - csum0[..., tau]
    e0 = energy[..., :1]

    fft_len = (_fast_fft_len(buf + n_lags_out) if n_lags_out < n_lags
               else 2 * buf)
    fa = torch.fft.rfft(a, n=fft_len, dim=-1)
    fx = torch.fft.rfft(x, n=fft_len, dim=-1)
    cross = torch.fft.irfft(torch.conj(fa) * fx, n=fft_len,
                            dim=-1)[..., :n_lags_out]
    return torch.clamp_min(e0 + energy - 2.0 * cross, 0.0)


def yin_frame(window: torch.Tensor, sample_rate: int, tolerance: float = 0.8,
              fmin: float | None = None,
              fmax: float | None = None) -> torch.Tensor:
    """F0 in Hz for window(s) ``[..., buf]``; 0.0 where unvoiced.
    ``fmin``/``fmax`` optionally bound the period search (None = the full
    aubio-parity lag range)."""
    buf = window.shape[-1]
    p_lo, p_hi, n_lags_out, bounded = _search_bounds(
        buf, sample_rate, fmin, fmax)
    d = _difference_function(window.float(), buf // 2, n_lags_out=n_lags_out)
    return _select_pitch(_cmndf(d), sample_rate, tolerance, p_lo, p_hi,
                         bounded)


def _pad_stream(audio: torch.Tensor, buf: int, hop: int):
    """aubio slide-block stream layout: ``buf - hop`` leading zeros, audio,
    trailing zeros to the last hop boundary. Returns (padded, n_hops)."""
    t = audio.shape[-1]
    n_hops = -(-t // hop)
    total = buf - hop + n_hops * hop
    return F.pad(audio, (buf - hop, total - (buf - hop) - t)), n_hops


@functools.lru_cache(maxsize=None)
def _dft_corr_mats(hop: int, tau_out: int, f_need: int, n: int):
    """Real DFT / inverse matrices of the matmul-DFT route (designed in
    float64, cast to fp32): the forward cosine/sine bank for one hop
    block, the block-shift twiddles ``e^{-2πi·m·hop·k/N}``, and the
    weighted inverse bank that lands directly on the lag axis."""
    k = n // 2 + 1
    w = 2.0 * np.pi / n
    kk = np.arange(k)[None, :]
    ia = np.arange(hop)[:, None]
    cos_f = np.cos(w * ia * kk).astype(np.float32)
    sin_f = np.sin(w * ia * kk).astype(np.float32)
    mm = np.arange(f_need)[:, None]
    tw_re = np.cos(w * mm * hop * kk).astype(np.float32)
    tw_im = -np.sin(w * mm * hop * kk).astype(np.float32)
    wk = np.full(k, 2.0)
    wk[0] = 1.0
    if n % 2 == 0:
        wk[-1] = 1.0
    kc = np.arange(k)[:, None]
    tau = np.arange(tau_out)[None, :]
    cos_t = (np.cos(w * kc * tau) * wk[:, None] / n).astype(np.float32)
    sin_t = (np.sin(w * kc * tau) * wk[:, None] / n).astype(np.float32)
    return cos_f, sin_f, tw_re, tw_im, cos_t, sin_t


def _dft_setup(padded: torch.Tensor, nblk: int, hop: int, n_lags_out: int):
    """The route's hop blocks ``[b, n_blocks, hop]``, its matrices on the
    signal's device and the span's block count ``f_need``."""
    b = int(np.prod(padded.shape[:-1], dtype=np.int64))
    x = padded.reshape(b, padded.shape[-1]).float()
    span = hop - 1 + n_lags_out
    f_need = -(-span // hop)
    n_blocks = nblk + f_need - 1
    total = n_blocks * hop
    if x.shape[-1] < total:
        x = F.pad(x, (0, total - x.shape[-1]))
    blocks = x[:, :total].reshape(b, n_blocks, hop)
    mats = tuple(torch.from_numpy(m).to(padded.device) for m in
                 _dft_corr_mats(hop, n_lags_out, f_need, f_need * hop))
    return blocks, mats, f_need


def _assemble_spans(re: torch.Tensor, im: torch.Tensor, tw_re: torch.Tensor,
                    tw_im: torch.Tensor, nblk: int, f_need: int):
    """Span spectra by the shift theorem: row ``blk``'s span is blocks
    blk..blk+f_need−1, XB[k] = Σ_m e^{-2πi·m·hop·k/N}·G[blk+m, k], summed
    in ascending m."""
    o_re = torch.zeros_like(re[:, :nblk])
    o_im = torch.zeros_like(o_re)
    for m in range(f_need):
        gr, gi = re[:, m: m + nblk], im[:, m: m + nblk]
        twr, twi = tw_re[m][None, None], tw_im[m][None, None]
        o_re = o_re + (twr * gr - twi * gi)
        o_im = o_im + (twr * gi + twi * gr)
    return o_re, o_im


def _block_sums_dft(padded: torch.Tensor, nblk: int, hop: int,
                    n_lags_out: int) -> torch.Tensor:
    """``bs[..., nblk, n_lags_out]`` = Σ_{i<hop} x[b·hop+i]·x[b·hop+τ+i]
    via matmul-DFT linear correlation: each block's leading ``hop``
    samples correlated against its ``f_need``-block span, with DFT length
    N = f_need·hop ≥ hop − 1 + n_lags_out (no wrap)."""
    blocks, mats, f_need = _dft_setup(padded, nblk, hop, n_lags_out)
    cos_f, sin_f, tw_re, tw_im, cos_t, sin_t = mats
    g_re = torch.matmul(blocks, cos_f)                # [b, n_blocks, K]
    g_im = -torch.matmul(blocks, sin_f)
    xb_re, xb_im = _assemble_spans(g_re, g_im, tw_re, tw_im, nblk, f_need)
    a_re, a_im = g_re[:, :nblk], g_im[:, :nblk]       # A = block blk, padded
    # P = conj(A)·B, then corr[τ] = (1/N)·Σ_k w_k·Re(P[k]·e^{+2πikτ/N})
    p_re = a_re * xb_re + a_im * xb_im
    p_im = a_re * xb_im - a_im * xb_re
    corr = torch.matmul(p_re, cos_t) - torch.matmul(p_im, sin_t)
    return corr.reshape(tuple(padded.shape[:-1]) + (nblk, n_lags_out))


def _window_sums(v: torch.Tensor, n_hops: int, r: int) -> torch.Tensor:
    """Σ over r consecutive block rows for each hop, by prefix
    differences along the block axis."""
    c0 = F.pad(torch.cumsum(v, dim=-2), (0, 0, 1, 0))
    k_idx = torch.arange(n_hops, device=v.device)
    return c0[..., k_idx + r, :] - c0[..., k_idx, :]


def _track_difference_dft(padded: torch.Tensor, n_hops: int, r: int,
                          hop: int, n_lags_out: int) -> torch.Tensor:
    """d(τ) for every hop window by the matmul-DFT route. Both terms of
    d = e0 + energy − 2·cross are correlations over the same spans: cross
    correlates each block against its span, energy a ones-window against
    the squared span; one stacked inverse matmul lands both."""
    nblk = n_hops + r - 1
    blocks, mats, f_need = _dft_setup(padded, nblk, hop, n_lags_out)
    cos_f, sin_f, tw_re, tw_im, cos_t, sin_t = mats
    zblocks = blocks * blocks
    g_re = torch.matmul(blocks, cos_f)
    g_im = -torch.matmul(blocks, sin_f)
    z_re = torch.matmul(zblocks, cos_f)
    z_im = -torch.matmul(zblocks, sin_f)
    xb_re, xb_im = _assemble_spans(g_re, g_im, tw_re, tw_im, nblk, f_need)
    zb_re, zb_im = _assemble_spans(z_re, z_im, tw_re, tw_im, nblk, f_need)
    a_re, a_im = g_re[:, :nblk], g_im[:, :nblk]
    # the ones-window spectrum: o[k] = Σ_{j<hop} e^{-2πijk/N}
    o_re = torch.sum(cos_f, dim=0)[None, None]
    o_im = -torch.sum(sin_f, dim=0)[None, None]
    p_re = torch.cat([a_re * xb_re + a_im * xb_im,
                      o_re * zb_re + o_im * zb_im], dim=1)
    p_im = torch.cat([a_re * xb_im - a_im * xb_re,
                      o_re * zb_im - o_im * zb_re], dim=1)
    corr = torch.matmul(p_re, cos_t) - torch.matmul(p_im, sin_t)
    cross = _window_sums(corr[:, :nblk], n_hops, r)
    energy = _window_sums(corr[:, nblk:], n_hops, r)
    # A window whose analysis half is exactly silent has cross ≡ 0; the
    # route's ~1e-6 relative noise would fabricate CMNDF dips there, so
    # those rows' cross is snapped to zero from exact block energies.
    arow = torch.sum(zblocks, dim=-1)                 # [b, n_blocks]
    acs = F.pad(_cumsum(arow), (1, 0))
    k_idx = torch.arange(n_hops, device=padded.device)
    ae = acs[:, k_idx + r] - acs[:, k_idx]            # [b, n_hops]
    cross = torch.where(ae[..., None] > 0.0, cross, torch.zeros_like(cross))
    e0 = energy[..., :1]
    d = torch.clamp_min(e0 + energy - 2.0 * cross, 0.0)
    # The sub-noise-floor snap (relative 1e-5 of the span energy): the
    # route's roundoff must not pass for CMNDF structure where exact
    # arithmetic gives d ≈ 0. It can flip a borderline voiced frame
    # against the block-sum route.
    emax = torch.amax(energy, dim=-1, keepdim=True)
    d = torch.where(d > 1e-5 * (e0 + emax), d, torch.zeros_like(d))
    return d.reshape(tuple(padded.shape[:-1]) + (n_hops, n_lags_out))


def _track_difference(audio: torch.Tensor, buf: int, hop: int,
                      n_lags_out: int, route: str = "kernel") -> torch.Tensor:
    """d(τ), τ ∈ [0, n_lags_out), for every hop window:
    ``[..., T] → [..., n_hops, n_lags_out]``. Requires ``hop | buf // 2``.
    ``route`` is ``"kernel"`` (block sums: the CUDA kernel on the card,
    its plain version on the CPU) or ``"dft"`` (plain matmuls)."""
    n_lags = buf // 2
    if n_lags % hop:
        raise ValueError("the signal-level routes require hop | buf // 2")
    r = n_lags // hop
    padded, n_hops = _pad_stream(audio.float(), buf, hop)
    if route == "dft":
        return _track_difference_dft(padded, n_hops, r, hop, n_lags_out)
    if route != "kernel":
        raise ValueError(f"unknown YIN route {route!r}")
    bs = block_sums(padded, n_hops + r - 1, hop, n_lags_out)
    # cross_k[τ] = Σ_{b=k}^{k+r-1} bs[b, τ], via block-prefix differences
    cross = _window_sums(bs, n_hops, r)

    # energy_k[τ] = Σ_{j=τ}^{τ+n_lags-1} w_k[j]² from squared prefix sums
    s0 = F.pad(_cumsum(padded * padded), (1, 0))
    k_idx = torch.arange(n_hops, device=audio.device)
    tau = torch.arange(n_lags_out, device=audio.device)[None, :]
    base = (hop * k_idx)[:, None] + tau
    energy = s0[..., base + n_lags] - s0[..., base]
    e0 = energy[..., :1]
    return torch.clamp_min(e0 + energy - 2.0 * cross, 0.0)


def _hop_windows(audio: torch.Tensor, buf: int, hop: int) -> torch.Tensor:
    """aubio's streaming slide-block windows for a whole signal: window k
    is the ``buf`` samples ending at hop boundary (k+1)·hop, with zeros
    before the stream starts. ``[..., T] → [..., n_hops, buf]``."""
    padded, n_hops = _pad_stream(audio, buf, hop)
    return padded.unfold(-1, buf, hop)[..., :n_hops, :]


def yin_track(audio: torch.Tensor, sample_rate: int, buf: int = 4096,
              hop: int = 512, tolerance: float = 0.8,
              fmin: float | None = None,
              fmax: float | None = None) -> torch.Tensor:
    """Per-hop F0 track ``[..., n_hops]`` in Hz (0 = unvoiced): the
    signal-level block-sum route where ``hop | buf // 2``, else the
    per-window FFT fallback."""
    buf, hop = int(buf), int(hop)
    if (buf // 2) % hop:
        windows = _hop_windows(audio.float(), buf, hop)
        return yin_frame(windows, sample_rate, tolerance, fmin=fmin,
                         fmax=fmax)
    p_lo, p_hi, n_lags_out, bounded = _search_bounds(
        buf, sample_rate, fmin, fmax)
    d = _track_difference(audio, buf, hop, n_lags_out)
    return _select_pitch(_cmndf(d), sample_rate, tolerance, p_lo, p_hi,
                         bounded)


def mean_voiced_pitch(track: torch.Tensor,
                      n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of strictly-positive F0 values (0 when fully unvoiced);
    ``n_valid`` masks padded hops."""
    voiced = track > 0.0
    if n_valid is not None:
        idx = torch.arange(track.shape[-1], device=track.device)
        voiced = voiced & (idx < n_valid[..., None])
    count = voiced.sum(dim=-1)
    total = torch.where(voiced, track, torch.zeros_like(track)).sum(dim=-1)
    return torch.where(count > 0, total / torch.clamp_min(count, 1),
                       torch.zeros_like(total))


def classify_pitch(mean_f0: torch.Tensor, deep: float = 120.0,
                   high: float = 200.0) -> torch.Tensor:
    """0=Deep (<deep), 1=Normal, 2=High (>=high); unvoiced → Normal."""
    code = torch.where(mean_f0 < deep, 0,
                       torch.where(mean_f0 < high, 1, 2))
    return torch.where(mean_f0 <= 0.0, 1, code).to(torch.int32)


def pitch_tag(code: int) -> str:
    return PITCH_TAGS[int(code)]
