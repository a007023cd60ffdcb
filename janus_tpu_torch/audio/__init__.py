"""Deterministic synthetic audio, the mu-law wire, WAV I/O and upload
decoding (numpy only)."""
