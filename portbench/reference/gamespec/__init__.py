"""A frozen copy of the port's DSL compiler (game_engine_tpu_torch/gamespec):
YAML game definitions -> typed GameSpec -> compiled IR -> tables. The
reference lowers each game itself and takes no table from the program."""
