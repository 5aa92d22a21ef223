"""The port's own copy of the DSL compiler: YAML game definitions -> typed
GameSpec -> compiled IR -> tables. Kept identical to the JAX package's
gamespec (tests/test_torch_gamespec.py holds the two to the same Lowered)."""
