"""Serving runtime: the phrase -> JanusPacket encoder, the JanusPacket
-> speech synthesizers (fused and streaming), the duplex engine and link,
the batched multi-session manager, the watchdog and the profiling
helpers."""
