"""Least work of the program's passes and kernels, from the
configuration's widths and the rows: operations, and bytes with each
input read once and each output written once. ``least_s`` turns a pair
into the least time on the card's published peaks (one H100 SXM: 989
TFLOP/s dense bf16, 3.35 TB/s of HBM; the peaks assume its 700 W limit).

Weights count at their serving width (2 bytes in bfloat16); activations
at the width the configuration runs them (the recogniser in bfloat16,
the TTS's AR step in float32 against bfloat16 weights, its prompt in
bfloat16).
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["Tally", "PEAK_FLOPS", "PEAK_BYTES", "least_s", "add", "mixed_linear",
           "decode_attention", "encoder_pass", "decoder_prefill",
           "decoder_step", "ar_step", "tts_prefill", "vocoder_pass",
           "ar_step_mixed_linears", "asr_params", "ENCODER_ROWS"]

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

Work = Tuple[float, float]


def least_s(work: Work) -> float:
    flops, nbytes = work
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


class Tally:
    """Passes completed: their operations, bytes and least time (each
    pass's least time taken alone, then summed)."""

    def __init__(self):
        self.flops = self.bytes = self.least_s = 0.0

    def add(self, w: Work, n: float = 1) -> "Tally":
        self.flops += n * w[0]
        self.bytes += n * w[1]
        self.least_s += n * least_s(w)
        return self

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "least_s": self.least_s}


def add(*works: Work) -> Work:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


def scale(work: Work, n: float) -> Work:
    return (work[0] * n, work[1] * n)


def mixed_linear(rows: int, k: int, n: int, x_bytes: int = 4,
                 w_bytes: int = 2, bias: bool = True) -> Work:
    """``x[rows, k] @ w[k, n] + b``: the weight and bias at ``w_bytes``,
    rows in and out at ``x_bytes``."""
    return (2.0 * rows * k * n,
            float(k * n * w_bytes + rows * k * x_bytes + rows * n * x_bytes
                  + (n * w_bytes if bias else 0)))


def decode_attention(batch: int, heads: int, tq: int, dh: int, t: int,
                     q_bytes: int = 2, kv_bytes: int = 2,
                     new_kv: bool = False) -> Work:
    """``tq`` query rows against ``t`` valid cache rows: the keys and
    values read, the queries read and the output written; with
    ``new_kv`` the step's own key and value rows read too (the cache's
    ``t`` already holds them once written)."""
    rows = batch * heads * tq * dh
    nbytes = 2 * batch * heads * t * dh * kv_bytes + 2 * rows * q_bytes
    if new_kv:
        nbytes += 2 * rows * q_bytes
    return (4.0 * rows * t, float(nbytes))


def asr_params(c: dict) -> Tuple[int, int]:
    """(encoder, decoder) parameter counts of a Whisper tree, the
    decoder's embeddings included."""
    d, ff = c["d_model"], c["d_model"] * c["mlp_ratio"]
    block = 4 * d * d + 3 * d + 2 * d * ff + ff + d + 4 * d
    enc = 3 * c["n_mels"] * d + d + 3 * d * d + d + c["encoder_layers"] * block + 2 * d
    dec_block = block + 4 * d * d + 3 * d + 2 * d
    dec = (c["vocab_size"] * d + c["max_target_positions"] * d
           + c["decoder_layers"] * dec_block + 2 * d)
    return enc, dec


ENCODER_ROWS = 2  # mel frames per encoder row (the stride-2 stem)


def encoder_pass(c: dict, batch: int, mel_frames: int, act_bytes: int = 2
                 ) -> Work:
    """The conv stem and encoder over ``batch`` rows of ``mel_frames``:
    every encoder weight read once, the log-mel in and the output out."""
    d, ff, L = c["d_model"], c["d_model"] * c["mlp_ratio"], c["encoder_layers"]
    t = mel_frames // ENCODER_ROWS
    flops = (2.0 * batch * mel_frames * 3 * c["n_mels"] * d
             + 2.0 * batch * t * 3 * d * d
             + L * (2.0 * batch * t * (4 * d * d + 2 * d * ff)
                    + 4.0 * batch * t * t * d))
    weights = asr_params(c)[0] * 2
    return (flops, float(weights + batch * mel_frames * c["n_mels"] * act_bytes
                         + batch * t * d * act_bytes))


def _decoder_tokens(c: dict, batch: int, tq: int, t_self: int,
                    t_cross: int, act_bytes: int) -> Work:
    d, ff, L = c["d_model"], c["d_model"] * c["mlp_ratio"], c["decoder_layers"]
    rows = batch * tq
    flops = (L * (2.0 * rows * (6 * d * d + 2 * d * ff)
                  + 4.0 * rows * (t_self + t_cross) * d)
             + 2.0 * rows * d * c["vocab_size"])
    weights = (L * (6 * d * d + 2 * d * ff) + c["vocab_size"] * d) * 2
    caches = L * 2 * batch * (t_self + t_cross) * d * act_bytes
    return (flops, float(weights + caches + rows * c["vocab_size"] * 4))


def decoder_prefill(c: dict, batch: int, prompt: int, t_cross: int,
                    act_bytes: int = 2) -> Work:
    """The prompt through the decoder, with every layer's cross K/V
    computed from the encoder output first."""
    d, L = c["d_model"], c["decoder_layers"]
    cross = (L * 2.0 * 2 * batch * t_cross * d * d,
             float(L * 2 * d * d * 2 + L * 2 * batch * t_cross * d * act_bytes
                   + batch * t_cross * d * act_bytes))
    return add(cross, _decoder_tokens(c, batch, prompt, prompt, t_cross,
                                      act_bytes))


def decoder_step(c: dict, batch: int, t_self: int, t_cross: int,
                 act_bytes: int = 2) -> Work:
    """One greedy step of ``batch`` rows with ``t_self`` valid self-cache
    rows (the new one included)."""
    return _decoder_tokens(c, batch, 1, t_self, t_cross, act_bytes)


def ar_step_mixed_linears(c: dict, rows: int = 1):
    """The AR step's linears as (rows, k, n, bias) in order: the prenet's
    two, each block's q/k/v (k without bias), out, fc1 and fc2, the mel
    and stop heads."""
    d, ff = c["d_model"], c["d_model"] * c["mlp_ratio"]
    r_mels = c["reduction"] * c["n_mels"]
    out = [(rows, r_mels, d, True), (rows, d, d, True)]
    for _ in range(c["layers"]):
        out += [(rows, d, d, True), (rows, d, d, False), (rows, d, d, True),
                (rows, d, d, True), (rows, d, ff, True), (rows, ff, d, True)]
    return out + [(rows, d, r_mels, True), (rows, d, 1, True)]


def ar_step(c: dict, batch: int, t: int) -> Work:
    """One AR step of ``batch`` rows with ``t`` valid cache rows (the new
    one included): float32 rows through bfloat16 weights, bfloat16
    caches."""
    lin = add(*(mixed_linear(r, k, n, bias=b)
                for r, k, n, b in ar_step_mixed_linears(c, batch)))
    dh = c["d_model"] // c["num_heads"]
    att = scale(decode_attention(batch, c["num_heads"], 1, dh, t, q_bytes=4,
                                 kv_bytes=2, new_kv=True), c["layers"])
    return add(lin, att)


def tts_prefill(c: dict, prompt: int, batch: int = 1) -> Work:
    """The prompt through the acoustic model in bfloat16, causal, its
    caches written, the heads at its last row."""
    d, ff, L = c["d_model"], c["d_model"] * c["mlp_ratio"], c["layers"]
    rows = batch * prompt
    r_mels = c["reduction"] * c["n_mels"]
    flops = L * (2.0 * rows * (4 * d * d + 2 * d * ff)
                 + 2.0 * batch * prompt * (prompt + 1) * d) \
        + 2.0 * batch * d * (r_mels + 1)
    weights = (L * (4 * d * d + 2 * d * ff) + d * (r_mels + 1)) * 2
    return (flops, float(weights + L * 2 * rows * d * 2 + rows * d * 2))


def vocoder_pass(c: dict, n_mels: int, frames: int) -> Work:
    """The vocoder over ``frames`` mel frames (float32 rows, bfloat16
    weights), its inverse STFT and the x2 upsampler: the mel in, the 48
    kHz samples out."""
    d, bins, L = c["d_model"], c["n_fft"] // 2 + 1, c["layers"]
    n_fft, hop = c["n_fft"], c["hop_length"]
    flops = (2.0 * frames * n_mels * d
             + L * (2.0 * 7 * frames * d + 2.0 * frames * 2 * d * 3 * d)
             + 2.0 * frames * d * 3 * bins
             + frames * 2.5 * n_fft * math.log2(n_fft)
             + 2.0 * 65 * 2 * frames * hop)
    weights = (n_mels * d + L * (7 * d + 6 * d * d) + 3 * d * bins) * 2
    return (flops, float(weights + frames * n_mels * 4 + 2 * frames * hop * 4))
