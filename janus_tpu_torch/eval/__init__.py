"""Evaluation: WER/CER/SNR/prosody metrics and the codec round-trip
gates on the demo and hard-corpus bundles."""
