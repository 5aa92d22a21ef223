"""DSL generation + validation pipeline."""
