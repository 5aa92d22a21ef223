"""The port's oracle (game_engine_tpu_torch/oracle/interp.py) and scripted
policy (policies/scripted.py) against the JAX package's: the same player
rows, phase, done flag and winner after every step, over every catalog game
at two seeds; and the golden trace hashes of tests/fixtures/golden_oracle.json
reproduced through the port's own gamespec, oracle and policy."""

import hashlib
import json
import os

import pytest

from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import games_dir, load_game_spec
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from game_engine_tpu_torch.gamespec import compile as PC
from game_engine_tpu_torch.gamespec import parser as PP
from game_engine_tpu_torch.oracle.interp import OracleRoom as PortRoom
from game_engine_tpu_torch.policies import scripted as PS
from tests.test_golden import FIXTURE, _CONFIG, _canon, _game_files

SEEDS = (3, 11)


def _port_game(game_file: str):
    name = os.path.splitext(game_file)[0]
    cfg = _CONFIG.get(name)
    pcfg = None if cfg is None else PC.GameConfig(rounds_per_player=cfg.rounds_per_player)
    return PC.compile_game(PP.load_game_spec(os.path.join(PP.games_dir(), game_file)),
                           pcfg or PC.GameConfig())


def _observed(room) -> tuple:
    return (room.phase.dsl_id, room.phase.name, room.done, room.winner, room.step_count,
            sorted(room.acted), {p: dict(row) for p, row in room.players.items()})


@pytest.mark.parametrize("game_file", _game_files())
def test_port_oracle_steps_like_the_jax_oracle(game_file):
    name = os.path.splitext(game_file)[0]
    jgame = compile_game(load_game_spec(os.path.join(games_dir(), game_file)),
                         _CONFIG.get(name))
    pgame = _port_game(game_file)
    n = int(jgame.spec.declaration.min_players)
    for seed in SEEDS:
        ref, got = OracleRoom(jgame, n_players=n, seed=seed), PortRoom(pgame, n_players=n,
                                                                       seed=seed)
        assert _observed(got) == _observed(ref)
        for t in range(600):
            acts = oracle_policy(ref, t, seed)
            assert PS.oracle_policy(got, t, seed) == acts, (name, seed, t)
            ref.step(acts)
            trace = got.step(acts)
            assert _observed(got) == _observed(ref), (name, seed, t)
            assert trace.done == ref.done and trace.winner == ref.winner
            if ref.done:
                break
        assert ref.done, (name, seed)
        assert got.snapshot() == ref.snapshot()


def _port_trace_hash(game_file: str, n_players: int, seed: int, max_steps: int = 600) -> str:
    """tests/test_golden.py trace_hash through the port's modules."""
    room = PortRoom(_port_game(game_file), n_players=n_players, seed=seed)
    h = hashlib.sha256()

    def record():
        step = {
            "phase": room.phase.dsl_id,
            "done": room.done,
            "winner": room.winner,
            "players": {
                str(p): {k: _canon(v) for k, v in sorted(row.items()) if k != "name"}
                for p, row in room.players.items()
            },
        }
        h.update(json.dumps(step, sort_keys=True).encode())

    record()
    for t in range(max_steps):
        room.step(PS.oracle_policy(room, t, seed))
        record()
        if room.done:
            break
    assert room.done, f"{game_file} n={n_players} seed={seed}: no finish"
    return h.hexdigest()


@pytest.mark.parametrize("game_file", _game_files())
def test_port_oracle_reproduces_the_golden_traces(game_file):
    with open(FIXTURE) as f:
        golden = json.load(f)
    keys = [k for k in golden if k.startswith(game_file + "|")]
    assert keys
    for k in keys:
        _, n, seed = k.split("|")
        assert _port_trace_hash(game_file, int(n[2:]), int(seed[5:])) == golden[k], k


def test_action_hash_and_pick_match():
    from game_engine_tpu.policies import scripted as JS

    for seed, step, pid in ((0, 0, 1), (7, 123, 5), (0xFFFFFFFF, 9, 12)):
        assert PS.action_hash(seed, step, pid) == JS.action_hash(seed, step, pid)
    for mask in ([True, False, True], [False] * 4, [True] * 6):
        for h in (0, 5, 0xDEADBEEF):
            assert PS.pick_from_mask(h, mask) == JS.pick_from_mask(h, mask)
