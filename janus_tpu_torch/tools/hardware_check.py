"""Audio-hardware smoke test (reference: backend/tests/hardware_check.py):
record one second from the default input, report RMS/peak, save a WAV.
Degrades to a synthetic capture in mock mode so the tool always runs.

Usage::

    python -m janus_tpu_torch.tools.hardware_check [--seconds 1.0] [--out check.wav]
"""

from __future__ import annotations

import argparse

import numpy as np

from janus_tpu_torch.audio.io import AudioService
from janus_tpu_torch.audio.wav import write_wav


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", default="hardware_check.wav")
    args = parser.parse_args()

    svc = AudioService()
    print(f"audio backend: {'MOCK (no hardware)' if svc.mock_mode else 'PortAudio'}")
    n_chunks = max(1, int(args.seconds / svc.chunk_seconds))
    chunks = [svc.read_chunk() for _ in range(n_chunks)]
    svc.close()
    audio = np.concatenate(chunks)

    rms = float(np.sqrt(np.mean(audio**2)))
    peak = float(np.abs(audio).max())
    print(f"captured {len(audio)} samples ({len(audio)/svc.SAMPLE_RATE:.2f}s)")
    print(f"rms={rms:.5f} peak={peak:.5f}")
    if rms < 1e-4:
        print("WARNING: capture is silent (expected in mock mode)")
    write_wav(args.out, audio, svc.SAMPLE_RATE)
    print(f"saved -> {args.out}")


if __name__ == "__main__":
    main()
