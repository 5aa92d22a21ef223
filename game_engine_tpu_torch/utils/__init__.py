"""Cross-cutting utilities: checkpointing, replay, metrics, tracing."""
