"""Enumerate audio capture/playback devices (reference:
backend/scripts/list_audio_devices.py). Degrades gracefully when PortAudio
is absent (the normal case on servers)."""

from __future__ import annotations


def list_devices() -> list:
    try:
        import pyaudio  # type: ignore
    except ImportError:
        print("PyAudio not installed — audio runs in mock/stream mode.")
        return []
    pa = pyaudio.PyAudio()
    devices = []
    for i in range(pa.get_device_count()):
        info = pa.get_device_info_by_index(i)
        devices.append(info)
        print(f"[{i}] {info['name']} "
              f"(in={info['maxInputChannels']}, out={info['maxOutputChannels']}, "
              f"sr={int(info['defaultSampleRate'])})")
    pa.terminate()
    return devices


if __name__ == "__main__":
    list_devices()
