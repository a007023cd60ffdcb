"""Plain receive path: the autoregressive acoustic transformer run
teacher-forced over a prompt and the mel groups a program served, the
Vocos-style vocoder, its inverse STFT and the 24 -> 48 kHz upsampler, in
float32 with TF32 off (the inverse STFT and the upsampler in float64).

The model, as the configuration states it: the prompt ``[SPK] [EMO]
text [BOA]`` embedded from one token table at positions ``0 .. P-1``;
each mel group (``reduction`` frames) re-enters through a two-layer GELU
prenet at position ``audio_base + g``; pre-norm blocks with causal
multi-head attention and a GELU MLP; a final norm; the mel and stop
heads. Position ``P - 1 + g`` predicts group ``g``. The vocoder: a linear
embedding, ConvNeXt blocks (depthwise k7 conv, norm, GELU MLP, layer
scale), a norm, a log-magnitude head (clamped to [-14, 6]) and a cos/sin
phase head, normalised. Nothing here reads the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.reference import dsp

__all__ = ["EMOTIONS", "emotion_tag", "prompt_ids", "predict_groups",
           "vocoder_spectra", "pcm48"]

Weights = Optional[Callable[[torch.Tensor], torch.Tensor]]

# the emotion tokens, in the order of the token table
EMOTIONS = ("neutral", "excited", "joyful", "whispering", "shouting", "sad",
            "relaxed", "panicked", "serious", "calm", "angry", "auto")


def emotion_tag(pitch: str, energy: str) -> str:
    """The prompt's emotion from a packet's categorical prosody."""
    if pitch == "High" and energy == "Loud":
        return "excited"
    if pitch == "High" and energy == "Normal":
        return "joyful"
    if energy == "Loud":
        return "shouting"
    if energy in ("Quiet", "Low"):
        return "whispering"
    return "relaxed"


def prompt_ids(text: bytes, bucket: int, emotion: str, text_vocab: int,
               pad: int) -> torch.Tensor:
    """``[SPK, EMO, text padded to bucket, BOA]``; the specials follow the
    text vocabulary: emotions, then BOA, then SPK."""
    emo = text_vocab + EMOTIONS.index(emotion)
    boa = text_vocab + len(EMOTIONS)
    spk = boa + 1
    body = list(text) + [pad] * (bucket - len(text))
    return torch.tensor([spk, emo] + body + [boa], dtype=torch.long)


def _w(t, weights: Weights):
    t = t.float()
    return weights(t) if weights is not None else t


def _lin(x, p, weights: Weights):
    y = x @ _w(p["w"], weights)
    return y + p["b"].float() if "b" in p else y


def _ln(x, p, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def _gelu(x):
    return F.gelu(x, approximate="none")


@torch.no_grad()
def predict_groups(tree: dict, heads: int, prompt: torch.Tensor,
                   groups: torch.Tensor, audio_base: int,
                   weights: Weights = None) -> torch.Tensor:
    """Teacher-forced mel prediction: ``prompt[P]`` token ids and the
    served ``groups[n, r*n_mels]``; returns ``[n, r*n_mels]``, row g the
    prediction of group g from the prompt and groups ``< g``."""
    dev = groups.device
    n = groups.shape[0]
    x = tree["token_emb"].float()[prompt.to(dev)]
    pn = tree["prenet"]
    audio = _lin(_gelu(_lin(groups[:n - 1].float(), pn["fc1"], weights)),
                 pn["fc2"], weights)
    pos = tree["pos_emb"].float()
    x = torch.cat([x + pos[:x.shape[0]],
                   audio + pos[audio_base:audio_base + n - 1]])[None]
    t = x.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=dev).triu(1)
    for blk in tree["blocks"]:
        h = _ln(x, blk["attn_ln"])
        a = blk["attn"]
        q, k, v = (_lin(h, a[s], weights).view(1, t, heads, -1).transpose(1, 2)
                   for s in ("q", "k", "v"))
        s = (q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])).masked_fill(
            mask, -math.inf)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(1, t, -1)
        x = x + _lin(o, a["out"], weights)
        h = _ln(x, blk["mlp_ln"])
        x = x + _lin(_gelu(_lin(h, blk["mlp"]["fc1"], weights)),
                     blk["mlp"]["fc2"], weights)
    h = _ln(x, tree["ln"])[0, prompt.shape[0] - 1:]
    return _lin(h, tree["mel_head"], weights)


@torch.no_grad()
def vocoder_spectra(tree: dict, n_fft: int, mel: torch.Tensor,
                    weights: Weights = None) -> torch.Tensor:
    """``mel[T, n_mels]`` -> complex spectra ``[T, n_fft//2 + 1]``."""
    x = _lin(mel.float(), tree["embed"], weights)
    t = x.shape[0]
    for blk in tree["blocks"]:
        w = _w(blk["dwconv"]["w"], weights)            # [K, D]
        k = w.shape[0]
        xp = F.pad(x, (0, 0, k // 2, k // 2))
        h = sum(xp[i:i + t] * w[i] for i in range(k)) + blk["dwconv"]["b"].float()
        h = _ln(h, blk["ln"])
        h = _lin(_gelu(_lin(h, blk["pw1"], weights)), blk["pw2"], weights)
        x = x + blk["gamma"].float() * h
    x = _ln(x, tree["ln_out"])
    mag = torch.exp(torch.clamp(_lin(x, tree["mag_head"], weights), -14.0, 6.0))
    ph = _lin(x, tree["phase_head"], weights)
    bins = n_fft // 2 + 1
    c, s = ph[:, :bins], ph[:, bins:]
    norm = torch.rsqrt(c * c + s * s + 1e-7)
    return torch.complex(mag * c * norm, mag * s * norm)


@torch.no_grad()
def pcm48(tree: dict, n_fft: int, hop: int, mel: torch.Tensor,
          weights: Weights = None) -> torch.Tensor:
    """``mel[T, n_mels]`` at 24 kHz frames -> float64 samples at 48 kHz
    (``2 * T * hop``), before clipping."""
    spec = vocoder_spectra(tree, n_fft, mel, weights)
    wav = dsp.istft(spec[None], n_fft, hop)
    return dsp.upsample_2(wav)[0]
