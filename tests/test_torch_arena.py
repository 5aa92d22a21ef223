"""The port's arena and exploitability probe (game_engine_tpu_torch/utils/
arena.py, eval_exploit.py) against the JAX package's scripts at the same
seeds, on the CPU (the search tiers' plain version, the policy tier's plain
K2): werewolf, rollouts 4 x horizon 80, 4 rooms. The tables, Elo fits and
every arm's win rate are equal."""

import contextlib
import io
import json
import os

import pytest

from game_engine_tpu_torch.utils import arena as TA
from game_engine_tpu_torch.utils import eval_exploit as TX
from tests.test_torch_native import jax_native  # noqa: F401  (autouse)
from tests.test_torch_net import CKPT
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

ROOMS, ROLLOUTS, HORIZON = 4, 4, 80


def test_arena_equals_jax(monkeypatch):
    from game_engine_tpu.utils import arena as JA

    for mod in (JA, TA):
        monkeypatch.setattr(mod, "ROLLOUTS", ROLLOUTS)
        monkeypatch.setattr(mod, "HORIZON", HORIZON)
    tiers = ["scripted", "search-det2", CKPT]
    want = JA.run_arena("werewolf", ROOMS, tiers)
    got = TA.run_arena("werewolf", ROOMS, tiers, device="cpu")
    assert got == want
    assert list(got["table"]) == ["scripted", "search-det2", "attn_werewolf_u120"]


def test_exploit_equals_jax(monkeypatch):
    from game_engine_tpu.utils import eval_exploit as JX

    argv = ["werewolf", os.path.relpath(CKPT), str(ROOMS), str(ROLLOUTS), str(HORIZON), "0"]
    monkeypatch.setenv("EXPLOIT_TPU", "1")  # the suite's JAX already runs on the CPU
    monkeypatch.setattr("sys.argv", ["eval_exploit"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        JX.main()
    want = json.loads(out.getvalue().splitlines()[-1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = TX.main(argv + ["--device", "cpu"])
    assert got == want == json.loads(out.getvalue().splitlines()[-1])


def test_arena_main_prints_the_table(monkeypatch, capsys):
    monkeypatch.setattr(TA, "ROLLOUTS", ROLLOUTS)
    monkeypatch.setattr(TA, "HORIZON", HORIZON)
    out = TA.main(["werewolf", "2", "scripted", CKPT, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out
    assert set(out) == {"game", "rooms", "n_players", "mode", "rows_play", "rollouts",
                        "horizon", "table", "elo"}
    with pytest.raises(SystemExit, match="unknown tier"):
        TA.run_arena("werewolf", 1, ["nonsense"], device="cpu")
