"""Import Whisper-family checkpoints into the port's ASR parameter tree.

Takes a flat ``name -> array`` state dict in HuggingFace ``WhisperModel``
naming (``model.encoder.layers.0.self_attn.q_proj.weight`` ...) and builds
the tree :mod:`janus_tpu_torch.models.asr` consumes: float32 tensors on the
CPU with per-layer ``blocks`` lists, as ``params_from_jax`` makes. Torch
``Linear`` stores ``y = x Wᵀ`` weights as ``[out, in]`` (transposed here);
``Conv1d`` stores ``[out, in, k]`` (permuted to ``[k, in, out]``). The
port's copy of the JAX package's ``models/import_whisper.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig

__all__ = ["params_from_hf_state_dict", "asr_config_from_hf"]


def _t(a) -> torch.Tensor:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    out = {"w": _t(np.asarray(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        out["b"] = _t(sd[f"{prefix}.bias"])
    return out


def _attn(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {
        "q": _linear(sd, f"{prefix}.q_proj"),
        "k": _linear(sd, f"{prefix}.k_proj"),
        "v": _linear(sd, f"{prefix}.v_proj"),
        "out": _linear(sd, f"{prefix}.out_proj"),
    }


def _mlp(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {"fc1": _linear(sd, f"{prefix}.fc1"),
            "fc2": _linear(sd, f"{prefix}.fc2")}


def _n_layers(sd: Mapping[str, np.ndarray], stack: str) -> int:
    return 1 + max(int(k.split(".")[2]) for k in sd
                   if k.startswith(f"{stack}.layers."))


def params_from_hf_state_dict(sd: Mapping[str, np.ndarray]) -> Dict:
    """The port's ASR tree from HF Whisper weights (numpy arrays or
    tensors)."""
    sd = {k.removeprefix("model."): (v.detach().cpu().numpy()
                                     if isinstance(v, torch.Tensor)
                                     else np.asarray(v))
          for k, v in sd.items()}

    enc_blocks = []
    for i in range(_n_layers(sd, "encoder")):
        p = f"encoder.layers.{i}"
        enc_blocks.append({
            "attn_ln": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "mlp_ln": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": _mlp(sd, p),
        })

    dec_blocks = []
    for i in range(_n_layers(sd, "decoder")):
        p = f"decoder.layers.{i}"
        dec_blocks.append({
            "attn_ln": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "cross_ln": _ln(sd, f"{p}.encoder_attn_layer_norm"),
            "cross": _attn(sd, f"{p}.encoder_attn"),
            "mlp_ln": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": _mlp(sd, p),
        })

    return {
        "encoder": {
            "conv1": {"w": _t(sd["encoder.conv1.weight"].transpose(2, 1, 0)),
                      "b": _t(sd["encoder.conv1.bias"])},
            "conv2": {"w": _t(sd["encoder.conv2.weight"].transpose(2, 1, 0)),
                      "b": _t(sd["encoder.conv2.bias"])},
            "blocks": enc_blocks,
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_emb": _t(sd["decoder.embed_tokens.weight"]),
            "pos_emb": _t(sd["decoder.embed_positions.weight"]),
            "blocks": dec_blocks,
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


def asr_config_from_hf(hf_config) -> ASRConfig:
    """Map a ``transformers.WhisperConfig`` (or any object with its
    fields) to :class:`ASRConfig`."""
    return ASRConfig(
        n_mels=hf_config.num_mel_bins,
        max_source_positions=hf_config.max_source_positions,
        d_model=hf_config.d_model,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        vocab_size=hf_config.vocab_size,
        max_target_positions=hf_config.max_target_positions,
    )
