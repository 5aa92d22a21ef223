"""utils/bench_games.py of the port against the JAX package's module:

- the seat count each game is benched at (the declared min_players, else
  the table width, clipped to [4, max_players]) equals the JAX module's for
  every catalog game, read from the JAX bench_game's own row with its
  rollout stubbed out (no jit);
- the episode count of the port's plain rollout equals JAX
  compiled_rollout's at equal seeds (32 rooms x 64 steps) on three of the
  default games;
- without a card the module raises: it never falls back to the CPU.
"""

import time

import numpy as np
import pytest
import torch

from game_engine_tpu.core import engine as JE
from game_engine_tpu.core import state as JS
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.utils import bench_games as JBG
from game_engine_tpu_torch.core.engine import make_rollout
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.utils import bench_games as BG
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import catalog_games


def test_default_games_are_the_jax_modules():
    assert BG.DEFAULT_GAMES == JBG.DEFAULT_GAMES


@pytest.mark.parametrize("game", catalog_games())
def test_players_rule_matches_jax(monkeypatch, game):
    seen = {}

    def stub_rollout(lowered, steps, auto_reset):
        def roll(state):
            time.sleep(1e-4)  # a nonzero median
            return state, 0
        return roll

    def stub_init(lowered, batch, n_players, seeds):
        seen["n_players"] = n_players

    monkeypatch.setattr(JE, "compiled_rollout", stub_rollout)
    monkeypatch.setattr(JS, "init_state", stub_init)
    row = JBG.bench_game(game, 1, 1, 1)
    lowered, n_players, n_phases = BG.game_setup(game)
    assert n_players == row["n_players"] == seen["n_players"]
    assert n_phases == row["n_phases"]
    assert 4 <= n_players <= lowered.P


@pytest.mark.parametrize("game", ["werewolf", "storm-forge", "masquerade-gala"])
def test_plain_rollout_episodes_match_jax(game):
    B, steps = 32, 64
    lowered, n_players, _ = BG.game_setup(game)
    _, eps = make_rollout(lowered, steps)(
        init_state(lowered, B, n_players, np.arange(B, dtype=np.uint32), device="cpu"))
    jl = lower(compile_game(load_builtin(game)))
    _, jeps = JE.compiled_rollout(jl, steps, auto_reset=True)(
        JS.init_state(jl, B, n_players, np.arange(B, dtype=np.uint32)))
    assert int(eps) == int(jeps) > 0


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BG.bench_game("werewolf", 8, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BG.main(["8", "2", "1", "werewolf"])
