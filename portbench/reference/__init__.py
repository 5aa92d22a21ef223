"""The plain reference that decides `correct`: plain PyTorch and numpy,
frozen copies of the port's plain paths (see each module), importing
nothing of the program, of JAX or of the JAX package. It lowers each game
from its YAML itself and works out again whatever the program derived."""

from __future__ import annotations

import os


def lower_game(path: str):
    """The game file at `path` (relative to the checkout's root, or
    absolute) parsed, compiled and lowered by the reference's own copy of
    the compiler."""
    from portbench.reference.gamespec.compile import compile_game
    from portbench.reference.gamespec.parser import load_game_spec
    from portbench.reference.gamespec.tables import lower

    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), path)
    return lower(compile_game(load_game_spec(path)))
