"""Models: tokenizer, parameter trees, the Whisper-class recognizer, the
TTS transformer, the iSTFT vocoder, the speaker encoder and the demo zoo."""
