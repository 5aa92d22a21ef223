"""The port's evaluator (game_engine_tpu_torch/train/evaluate.py) against the
JAX package's train/evaluate.py on the CPU:

  make_vs          with JAX's own Gumbel draws (k, s1, s2 = split(k, 3) a
                   step): minority wins and episodes exactly equal
  elo_fit          equal to JAX's on a given table (a verbatim copy), and the
                   JAX suite's synthetic-ratings case on the port
  matchup_table    the shipped league checkpoints at a tiny size:
                   names, rates in [0, 1], the same table twice
  main             --matchup and --checkpoint on --device cpu print the JAX
                   script's keys
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.train import evaluate as JE
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch.train import evaluate as E
from game_engine_tpu_torch.train import ppo as P
from tests.test_torch_net import REPO, host_state, jax_params, port_cfg, port_params, to_np
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

CKPTS = [os.path.join(REPO, "docs", "checkpoints", f"attn_werewolf_{n}.npz")
         for n in ("league_anchor_u600", "league_noanchor_u300")]
B, N_SEATS, STEPS = 8, 6, 24


def _noise(key, P_, A):
    out, k = [], key
    for _ in range(STEPS):
        k, s1, s2 = jax.random.split(k, 3)
        out.append(tuple(torch.from_numpy(to_np(jax.random.gumbel(s, (B, P_, A))).copy())
                         for s in (s1, s2)))
    return out


@pytest.mark.parametrize("seed", [3, 8])
def test_make_vs_matches_jax(seed):
    pair = builtin_pair("werewolf")
    lw, pw = pair.jax, pair.port
    jcfg, jmin = jax_params(lw, "attn", hidden=32, seed=seed)
    _, jmaj = jax_params(lw, "attn", hidden=32, seed=seed + 1)
    jst = jax_init_state(lw, B, N_SEATS, np.arange(B, dtype=np.uint32) + seed)
    key = jax.random.PRNGKey(seed)
    jw, jd = JE.make_vs(lw, JP.PPOConfig(net=jcfg), STEPS)(jmin, jmaj, jst, key)
    from game_engine_tpu.policies import net as JN

    vs = E.make_vs(pw, P.PPOConfig(net=port_cfg(jcfg)), STEPS)
    w, d = vs(port_params(jmin), port_params(jmaj), host_state(jst),
              noise=_noise(key, lw.P, JN.action_space(lw)))
    assert (w, d) == (int(jw), int(jd))
    assert d > 0


def _table(seed):
    rng = np.random.default_rng(seed)
    names = [f"p{i}" for i in range(5)]
    return {r: {c: round(float(rng.random()), 4) for c in names} for r in names}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elo_fit_equals_jax(seed):
    table = _table(seed)
    got, want = E.elo_fit(table), JE.elo_fit(table)
    assert list(got["ratings"]) == list(want["ratings"])
    for k, v in want["ratings"].items():
        assert abs(got["ratings"][k] - v) <= 1e-9
    assert abs(got["minority_side_elo"] - want["minority_side_elo"]) <= 1e-9


def test_elo_fit_recovers_synthetic_ratings():
    """elo_fit on a matrix generated from known ratings + a minority-side
    handicap recovers the ordering, the gaps and the handicap."""
    true_elo = {"a": 200.0, "b": 0.0, "c": -200.0}
    side = -120.0
    k = np.log(10.0) / 400.0
    table = {r: {c: float(1.0 / (1.0 + np.exp(-k * (true_elo[r] - true_elo[c] + side))))
                 for c in true_elo} for r in true_elo}
    fit = E.elo_fit(table)
    assert list(fit["ratings"]) == ["a", "b", "c"]
    assert abs(fit["minority_side_elo"] - side) < 15.0
    for name, want in true_elo.items():
        assert abs(fit["ratings"][name] - want) < 15.0, (name, fit)


def test_matchup_table_on_shipped_checkpoints():
    pw = builtin_pair("werewolf").port
    from game_engine_tpu_torch.policies import net as N

    cfg = P.PPOConfig(net=N.load_policy(CKPTS[0], "cpu")[1])
    tables = [E.matchup_table(pw, cfg, CKPTS, 4, 12, N_SEATS, 5, device="cpu")
              for _ in range(2)]
    assert tables[0] == tables[1]
    names = ["attn_werewolf_league_anchor_u600", "attn_werewolf_league_noanchor_u300"]
    assert list(tables[0]) == names and all(list(r) == names for r in tables[0].values())
    assert all(0.0 <= v <= 1.0 for r in tables[0].values() for v in r.values())


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = E.main(argv)
    return res, json.loads(out.getvalue().splitlines()[0])


def test_main_matchup_and_checkpoint_on_cpu():
    res, line = _main(["--device", "cpu", "--batch", "4", "--steps", "8", "--matchup"] + CKPTS)
    assert res == line
    assert set(line) == {"game", "mode", "rows_play", "table", "elo"}
    assert set(line["elo"]) == {"ratings", "minority_side_elo"}
    res, line = _main(["--device", "cpu", "--batch", "4", "--steps", "8", "--checkpoint",
                       CKPTS[1]])
    assert set(line) == {"game", "checkpoint", "learned_as_minority", "learned_as_majority"}
    assert set(line["learned_as_minority"]) == {"minority_win_rate", "episodes"}
