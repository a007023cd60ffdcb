"""Hand-send packets to a live receiver (reference:
backend/tests/manual_sender.py): type text, choose mode/prosody, and the
packet goes out over the throttled link — for cross-machine smoke tests
without a microphone.

Usage::

    TARGET_IP=10.0.0.2 TARGET_PORT=5005 python -m janus_tpu_torch.tools.manual_sender \
        --text "radio check" --mode semantic --energy Loud --pitch High
"""

from __future__ import annotations

import argparse

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.runtime.emotion import api_mode_to_protocol
from janus_tpu_torch.runtime.link import LinkSimulator


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--text", required=True)
    parser.add_argument("--mode", default="semantic",
                        choices=("semantic", "text_only", "morse"))
    parser.add_argument("--energy", default="Normal",
                        choices=("Quiet", "Normal", "Loud"))
    parser.add_argument("--pitch", default="Normal",
                        choices=("Deep", "Normal", "High"))
    parser.add_argument("--override", default="Auto")
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()

    cfg = JanusConfig.from_env()
    link = LinkSimulator(cfg.link)
    packet = JanusPacket(
        text=args.text,
        mode=api_mode_to_protocol(args.mode),
        prosody={"energy": args.energy, "pitch": args.pitch},
        override_emotion=args.override,
    )
    payload = packet.serialize()
    print(f"packet: {len(payload)}B, airtime {link.airtime(len(payload)):.2f}s "
          f"@ {cfg.link.baud_rate}bps -> {cfg.link.target_ip}:{cfg.link.target_port} "
          f"({'TCP' if cfg.link.use_tcp else 'UDP'})")
    for i in range(args.repeat):
        link.transmit(payload)
        print(f"sent {i + 1}/{args.repeat}")
    link.close()


if __name__ == "__main__":
    main()
