"""Deterministic synthetic audio, the mu-law wire, WAV I/O, capture and
playback, and upload decoding (WAV, WebM/Opus and Ogg/Opus through
libopus)."""
