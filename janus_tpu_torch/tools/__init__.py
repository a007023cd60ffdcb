"""Command-line tools: the standalone sender and receiver, the in-process
demo round trip, a hand sender, the audio-hardware check and the audio
device list."""
