"""Loss functions of the four trainable model families.

The port's copy of the JAX package's ``train/losses.py``: the same terms,
weights and reductions. The optax losses are written out in their exact
log forms: ``softmax_cross_entropy_with_integer_labels`` as
``logsumexp - logit[label]`` (a log-softmax) and
``sigmoid_binary_cross_entropy`` as ``-y log σ(x) - (1 - y) log σ(-x)``
(log-sigmoids), never a clamped probability.

``asr_loss`` runs the decoder teacher-forced through the same cached path
that greedy decoding uses: the self-attention cache is written in place
(:meth:`~janus_tpu_torch.ops.attention.KVCache.append_lockstep`), which
autograd records as a slice copy, so its gradient is that of the JAX
package's ``dynamic_update_slice``.

Every reduction over the batch goes through
:func:`~janus_tpu_torch.parallel.collectives.dp_sum` / ``dp_mean``:
outside a data-parallel trainer step these are the plain sum and mean;
inside one they reduce over the global batch, so a masked mean divides
the whole batch's masked sum by its whole mask (the mean of per-rank
means differs whenever the ranks' token counts do), as the JAX package's
losses do over a global batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from janus_tpu_torch.common.config import ASRConfig, TTSConfig, VocoderConfig
from janus_tpu_torch.models import asr as asr_mod
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models import vad as vad_mod
from janus_tpu_torch.models.vocoder import (spectra_to_waveform,
                                            vocoder_spectra)
from janus_tpu_torch.ops.stft import stft
from janus_tpu_torch.parallel.collectives import dp_mean, dp_size, dp_sum

__all__ = ["asr_loss", "tts_loss", "vocoder_loss", "vad_loss"]

Tensor = torch.Tensor


def asr_loss(params, cfg: ASRConfig, mel: Tensor, tokens: Tensor,
             token_mask: Tensor) -> Tuple[Tensor, Dict]:
    """Teacher-forced seq2seq cross-entropy.

    ``mel[B, T, n_mels]``; ``tokens[B, L]`` includes the sot prefix and the
    eot terminator; ``token_mask[B, L]`` marks real (loss-bearing) targets.
    Position i's logits predict token i+1.
    """
    enc = asr_mod.encode_audio(params, cfg, mel)
    state = asr_mod.init_decode_state(params, cfg, enc,
                                      max_len=tokens.shape[1])
    logits, _ = asr_mod._decoder_forward(params, cfg, tokens[:, :-1].long(),
                                         0, state)
    targets = tokens[:, 1:].long()
    mask = token_mask[:, 1:].float()
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                       targets[..., None])[..., 0]
    denom = torch.clamp_min(dp_sum(mask.sum()), 1.0)
    loss = dp_sum((ce * mask).sum()) / denom
    acc = dp_sum(((logits.argmax(-1) == targets).float() * mask).sum()) / denom
    return loss, {"asr_ce": loss, "asr_acc": acc}


def tts_loss(params, cfg: TTSConfig, text_ids: Tensor, emotion: Tensor,
             mel_groups: Tensor, group_mask: Tensor,
             speaker: Optional[Tensor] = None, text_vocab: int = 261,
             mel_inputs: Optional[Tensor] = None) -> Tuple[Tensor, Dict]:
    """Teacher-forced L1+L2 mel regression plus stop-flag BCE.

    ``mel_groups[B, S, r*n_mels]`` targets; ``group_mask[B, S]`` marks real
    groups (the last real group is the stop target). ``mel_inputs``
    optionally corrupts the teacher-forced prefix (exposure-bias
    regularization, see ``tts_forward``)."""
    mel_pred, stop_logits = tts_mod.tts_forward(
        params, cfg, text_ids, emotion, mel_groups, speaker, text_vocab,
        mel_inputs=mel_inputs)
    m = group_mask.float()
    denom = torch.clamp_min(dp_sum(m.sum()), 1.0)
    diff = mel_pred - mel_groups
    l1 = dp_sum((diff.abs().mean(-1) * m).sum()) / denom
    l2 = dp_sum(((diff ** 2).mean(-1) * m).sum()) / denom

    # stop target: 1 at the final real group of each sequence
    last_idx = torch.clamp_min(m.sum(-1) - 1, 0).long()
    stop_target = F.one_hot(last_idx, mel_groups.shape[1]).to(
        stop_logits.dtype)
    bce = -(stop_target * F.logsigmoid(stop_logits)
            + (1 - stop_target) * F.logsigmoid(-stop_logits))
    stop = dp_sum((bce * m).sum()) / denom

    loss = l1 + l2 + 0.5 * stop
    return loss, {"tts_l1": l1, "tts_l2": l2, "tts_stop": stop}


def _norm(x: Tensor) -> Tensor:
    """Frobenius norm over the global batch."""
    if dp_size() == 1:
        return torch.linalg.norm(x)
    return torch.sqrt(dp_sum(x.square().sum()))


# the two magnitude resolutions (n_fft, hop) of the multi-resolution term
STFT_RESOLUTIONS = ((512, 128), (1024, 256))


def vocoder_loss(params, cfg: VocoderConfig, mel: Tensor, target_wav: Tensor
                 ) -> Tuple[Tensor, Dict]:
    """Multi-resolution STFT loss + L1 waveform for the iSTFT vocoder.

    ``mel[B, T, n_mels]`` (the vocoder's own input representation),
    ``target_wav[B, T*hop]``.

    Phase supervision: the predicted complex spectra are compared per
    frame with the true windowed STFT on the vocoder's own grid (``stft``
    and ``istft`` are an exact centered round trip, so matching spectra
    means matching waveform). Waveform L1 alone conditions phase poorly
    through the overlap-add, and the magnitude terms are phase-blind.
    """
    spec_pred = vocoder_spectra(params, cfg, mel)
    pred = spectra_to_waveform(cfg, spec_pred, length=target_wav.shape[-1])
    l1 = dp_mean((pred - target_wav).abs())

    t = spec_pred.shape[-2]
    spec_true = stft(target_wav, n_fft=cfg.n_fft, hop=cfg.hop_length)[..., :t, :]
    cplx = dp_mean((spec_pred - spec_true).abs()) / (
        dp_mean(spec_true.abs()) + 1e-6)

    sc_total = 0.0
    mag_total = 0.0
    for n_fft, hop in STFT_RESOLUTIONS:
        sp = stft(pred, n_fft=n_fft, hop=hop).abs()
        st = stft(target_wav, n_fft=n_fft, hop=hop).abs()
        sc_total = sc_total + _norm(sp - st) / torch.clamp_min(_norm(st),
                                                                1e-6)
        mag_total = mag_total + dp_mean((torch.log(sp + 1e-5)
                                         - torch.log(st + 1e-5)).abs())
    n_res = len(STFT_RESOLUTIONS)
    loss = 10.0 * l1 + 4.0 * cplx + sc_total / n_res + mag_total / n_res
    return loss, {"voc_l1": l1, "voc_cplx": cplx, "voc_sc": sc_total / n_res,
                  "voc_mag": mag_total / n_res}


def vad_loss(params, chunk_16k: Tensor, label: Tensor) -> Tuple[Tensor, Dict]:
    """BCE on speech/non-speech chunk labels (probabilities offset by
    1e-6 inside the logs, as in the JAX package)."""
    prob = vad_mod.vad_model_prob(params, chunk_16k)
    eps = 1e-6
    bce = -(label * torch.log(prob + eps)
            + (1 - label) * torch.log(1 - prob + eps))
    loss = dp_mean(bce)
    acc = dp_mean(((prob > 0.5) == (label > 0.5)).float())
    return loss, {"vad_bce": loss, "vad_acc": acc}
