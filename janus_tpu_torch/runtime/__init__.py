"""Serving runtime: the phrase -> JanusPacket encoder and the JanusPacket
-> speech synthesizers (fused and streaming)."""
