"""Control plane: REST + WebSocket API (stdlib asyncio implementation, no
third-party web or schema package)."""
