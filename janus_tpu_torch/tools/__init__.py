"""Command-line tools: the standalone sender and receiver."""
