"""End-to-end demo: synthetic speech → packet bytes → reconstructed audio.

The verify-skill drive: runs the whole codec in-process and prints wire
stats. ``--wav out.wav`` saves the reconstruction.

Usage::

    python -m janus_tpu_torch.tools.demo_roundtrip [--seconds 1.5] [--wav out.wav]
        [--small] [--device cuda|cpu]

The encoder and the synthesizer run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from janus_tpu_torch.audio.synthetic import voiced_phrase
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.synthesizer import Synthesizer


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=1.5)
    parser.add_argument("--f0", type=float, default=190.0)
    parser.add_argument("--amp", type=float, default=0.12)
    parser.add_argument("--wav", help="save reconstructed audio here")
    parser.add_argument("--small", action="store_true",
                        help="use tiny test-model geometry (fast on CPU)")
    parser.add_argument("--device", default="cuda",
                        help="device for the encoder and the synthesizer "
                             "(default: cuda)")
    args = parser.parse_args()

    cfg = JanusConfig()
    if args.small:
        cfg = cfg.override(**{
            "asr.d_model": 64, "asr.encoder_layers": 1, "asr.decoder_layers": 1,
            "asr.num_heads": 4, "asr.n_mels": 16, "asr.vocab_size": 261,
            "asr.max_source_positions": 512, "asr.max_target_positions": 64,
            "asr.max_decode_tokens": 6,
            "tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
            "tts.n_mels": 16, "tts.max_mel_frames": 64,
            "vocoder.d_model": 64, "vocoder.layers": 2, "vocoder.n_fft": 256,
            "vocoder.hop_length": 64,
        })

    encoder = SemanticEncoder(cfg, buckets=(48_000 * 2, 48_000 * 8),
                              device=args.device)
    synth = Synthesizer(cfg, device=args.device)

    phrase = voiced_phrase(f0=args.f0, amp=args.amp, seconds=args.seconds)
    print(f"input: {len(phrase)/48000:.2f}s @48kHz "
          f"(f0={args.f0}Hz, amp={args.amp})")

    t0 = time.perf_counter()
    packet = encoder.encode_packet(phrase) or JanusPacket(
        text="(untrained transcript)", prosody={"energy": "Normal", "pitch": "Normal"}
    )
    encode_ms = 1e3 * (time.perf_counter() - t0)
    wire = packet.serialize()
    print(f"encode: {encode_ms:.0f}ms -> {len(wire)}B packet "
          f"({len(wire)/37.5:.2f}s airtime @300bps)")
    print(f"  text={packet.text!r} prosody={packet.prosody}")

    rx = JanusPacket.deserialize(wire)
    t0 = time.perf_counter()
    audio = synth.synthesize(rx)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    n = len(audio) // 2
    print(f"decode: {decode_ms:.0f}ms -> {n} samples ({n/48000:.2f}s @48kHz)")

    if args.wav:
        from janus_tpu_torch.audio.wav import write_wav

        pcm = np.frombuffer(audio, dtype=np.int16)
        write_wav(args.wav, pcm, 48000)
        print(f"saved: {args.wav}")


if __name__ == "__main__":
    main()
