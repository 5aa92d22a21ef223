"""Plain-Python oracle interpreter — the pinned semantic reference."""
