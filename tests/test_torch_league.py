"""The port's league (game_engine_tpu_torch/train/league.py, run.py
--league) against the JAX package's train/league.py on the CPU:

  League                      ids, eviction, the sampled id sequence and the
                              win-rate EMAs exactly equal under one numpy
                              seed; the JAX suite's pool and anchor cases
                              on both classes
  league unroll               with JAX's own Gumbel draws, both arms:
                              actions, rewards, dones, masks, learner wins
                              and the engine state exact; obs exact; logp
                              and value within 2e-2 (test_torch_ppo.py's)
  one league update           loss within 2e-2, the Adam step within 5e-2
                              (test_adam_update_matches_optax's rule)
  packed weights              the host pipeline's forward over a league
                              unroll packs once per parameter state
  run.main --league           both arms, snapshots under --league-dir that
                              the JAX matchup_table loads, and JAX
                              save_tree snapshots that the port's loads
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from game_engine_tpu.core.state import GameState as JaxGameState
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train import evaluate as JE
from game_engine_tpu.train import league as JL
from game_engine_tpu.train import ppo as JP
from game_engine_tpu.utils.checkpoint import save_tree
from game_engine_tpu_torch.core.engine import BatchedEngine
from game_engine_tpu_torch.core.state import init_state, state_to_numpy
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import evaluate as E
from game_engine_tpu_torch.train import league as L
from game_engine_tpu_torch.train import ppo as P
from tests.test_torch_net import host_state, jax_params, port_cfg, port_params, rel_err, to_np
from tests.test_torch_ppo import run_main
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

B, N_SEATS, T = 8, 6, 6


@pytest.fixture(scope="module")
def ww_pair():
    return builtin_pair("werewolf")


# ---------------------------------------------------------------------------
# League bookkeeping
# ---------------------------------------------------------------------------

CLASSES = {"jax": (JL.League, lambda: {"w": np.ones(2)}),
           "port": (L.League, lambda: {"w": torch.ones(2)})}


@pytest.mark.parametrize("side", list(CLASSES))
def test_league_pool_management(side):
    League, make = CLASSES[side]
    lg = League(max_size=3, snapshot_every=2, anchor=False)
    p = make()
    snaps = [lg.maybe_snapshot(p) for _ in range(8)]
    assert snaps == [True, False, True, False, True, False, True, False]
    assert len(lg.params_pool) == 3  # capped
    ids = lg.ids()
    assert ids == [1, 2, 3], ids  # id 0 evicted; ids are stable, not positions
    rng = np.random.default_rng(0)
    sid, opp = lg.sample_opponent(rng)
    assert sid in ids
    for _ in range(20):
        lg.record_result(ids[0], 0.0)  # the learner always loses to this one
        lg.record_result(ids[1], 1.0)
        lg.record_result(ids[2], 1.0)
    counts = {i: 0 for i in ids}
    for _ in range(300):
        i, _ = lg.sample_opponent(rng)
        counts[i] += 1
    assert counts[ids[0]] > counts[ids[1]] and counts[ids[0]] > counts[ids[2]]
    lg.record_result(0, 1.0)  # an evicted id's result is dropped
    assert lg.ids() == ids


@pytest.mark.parametrize("side", list(CLASSES))
def test_league_anchor_sampling(side):
    League, make = CLASSES[side]
    lg = League(max_size=2, snapshot_every=1)  # anchor defaults on
    p = make()
    for _ in range(5):
        lg.maybe_snapshot(p)
    assert len(lg.params_pool) == 2  # the anchor is not in the snapshot pool
    rng = np.random.default_rng(0)
    for _ in range(30):
        for sid in lg.ids():
            lg.record_result(sid, 1.0)
        lg.record_result(League.ANCHOR_ID, 0.0)
    hits = sum(1 for _ in range(200) if lg.sample_opponent(rng)[0] == League.ANCHOR_ID)
    assert hits > 150, hits
    anchor_params = [o for i, o in (lg.sample_opponent(rng) for _ in range(50))
                     if i == League.ANCHOR_ID]
    assert anchor_params and all(o is None for o in anchor_params)


@pytest.mark.parametrize("anchor", [True, False])
def test_league_bookkeeping_equals_jax(anchor):
    """One script of snapshots, draws and results on both classes, from one
    numpy seed each: the same ids, evictions, draws and EMAs, exactly."""
    jl = JL.League(max_size=4, snapshot_every=3, anchor=anchor)
    pl = L.League(max_size=4, snapshot_every=3, anchor=anchor)
    jrng, prng, script = (np.random.default_rng(5), np.random.default_rng(5),
                          np.random.default_rng(6))
    jp, pp = {"w": np.zeros(3)}, {"w": torch.zeros(3)}
    for u in range(40):
        assert jl.maybe_snapshot(jp) == pl.maybe_snapshot(pp)
        jid, jopp = jl.sample_opponent(jrng)
        pid, popp = pl.sample_opponent(prng)
        assert jid == pid, u
        assert (jopp is None) == (popp is None)
        rate = float(script.random())
        stale = int(script.integers(-1, 12))  # sometimes an evicted or the anchor's id
        for lg in (jl, pl):
            lg.record_result(jid, rate)
            lg.record_result(stale, 1.0 - rate)
        assert jl.ids() == pl.ids()
        assert jl.learner_winrate == pl.learner_winrate
        assert jl._anchor_winrate == pl._anchor_winrate


def test_snapshots_are_new_tensors():
    """A snapshot holds copies: the learner's in-place Adam step leaves it
    as it was, and its storage is its own."""
    pw = builtin_pair("werewolf").port
    cfg = P.PPOConfig(net=N.NetConfig(hidden=32, arch="attn"))
    params, opt = P.init_training(pw, cfg, torch.Generator().manual_seed(0), device="cpu")
    lg = L.League(snapshot_every=1)
    lg.maybe_snapshot(params)
    snap = lg.params_pool[0]
    before = {k: v.clone() for k, v in snap.items()}
    for k, p in params.items():
        assert snap[k].data_ptr() != p.data_ptr() and not snap[k].requires_grad
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(torch.equal(snap[k], before[k]) for k in snap)
    assert not all(torch.equal(snap[k], params[k].detach()) for k in snap)


# ---------------------------------------------------------------------------
# the league step against JAX's, with JAX's draws
# ---------------------------------------------------------------------------

def mid_game(pw, seed):
    """Rooms 8 steps into a scripted game (the port's engine, which equals
    the JAX package's), so episodes end within T steps."""
    eng = BatchedEngine(pw, "cpu")
    st = eng.init(B, N_SEATS, np.arange(B, dtype=np.uint32) + seed)
    for _ in range(8):
        st = eng.step(st, eng.bot_actions(st))
    return st


def _jax_unroll(lw, jcfg, scripted):
    """The JAX step's own unroll: make_league_train_step's closure."""
    jpc = JP.PPOConfig(horizon=T, epochs=1, net=jcfg)
    step = JL.make_league_train_step(lw, jpc, optax.adam(jpc.lr), scripted_opponent=scripted)
    return jpc, jax.jit(step), jax.jit(inspect.getclosurevars(step).nonlocals["unroll"])


def _jax_noise(key, P, A):
    """Per step (learner, opponent) Gumbel noise of JAX's key chain
    (k, sk1, sk2 = split(k, 3) a step) as CPU tensors."""
    out, k = [], key
    for _ in range(T):
        k, sk1, sk2 = jax.random.split(k, 3)
        out.append(tuple(torch.from_numpy(to_np(jax.random.gumbel(s, (B, P, A))).copy())
                         for s in (sk1, sk2)))
    return out


class JaxRun:
    """One arm's inputs and the JAX step's results on them: the unroll's
    outputs, the train step's, and JAX's gradient of that update."""

    def __init__(self, ww_pair, scripted, seed=31):
        lw = self.lw = ww_pair.jax
        self.pw = ww_pair.port
        self.jcfg, self.jp = jax_params(lw, "attn", hidden=32, seed=0)
        _, self.jo = jax_params(lw, "attn", hidden=32, seed=1)
        jpc, jstep, junroll = _jax_unroll(lw, self.jcfg, scripted)
        self.jst = JaxGameState(**{k: jnp.asarray(v) for k, v in
                                   state_to_numpy(mid_game(self.pw, seed)).items()})
        key = jax.random.PRNGKey(seed)
        self.cfg = P.PPOConfig(horizon=T, epochs=1, net=port_cfg(self.jcfg))
        self.noise = _jax_noise(key, lw.P, JN.action_space(lw))
        self.end, _, self.traj, self.won = junroll(self.jp, self.jo, self.jst, key)
        tx = optax.adam(jpc.lr)
        self.params, _, self.step_end, _, self.metrics = jstep(
            self.jp, self.jo, tx.init(self.jp), self.jst, key)
        _, last_v = JN.apply_net(self.jp, JN.observe(lw, self.end), self.jcfg, lw)
        adv, ret = JP.gae(self.traj, last_v, jpc)
        self.grads = jax.grad(lambda p: JP.ppo_loss(p, self.traj, adv, ret, jpc, lw)[0])(self.jp)


@pytest.fixture(scope="module", params=[False, True], ids=["snapshot", "anchor"])
def jax_run(request, ww_pair):
    return request.param, JaxRun(ww_pair, request.param)


def test_league_unroll_matches_jax(jax_run):
    scripted, j = jax_run
    unroll = L.make_league_unroll(j.pw, j.cfg, scripted_opponent=scripted)
    end, traj, won = unroll(port_params(j.jp), port_params(j.jo), host_state(j.jst),
                            noise=j.noise)
    for f in ("actions", "reward", "done", "mask", "legal"):
        got, want = getattr(traj, f).numpy(), np.asarray(getattr(j.traj, f))
        bad = np.argwhere(got != want)
        assert not len(bad), f"{f} differs first at (t, room, ...) {bad[0].tolist()}"
    np.testing.assert_array_equal(won.numpy(), np.asarray(j.won))
    np.testing.assert_array_equal(traj.obs.float().numpy(), to_np(j.traj.obs))
    assert rel_err(traj.value.numpy(), to_np(j.traj.value)) < 2e-2
    live = traj.mask.numpy()
    assert np.abs(traj.logp.numpy()[live] - to_np(j.traj.logp)[live]).max() < 2e-2
    for f, x in zip(end._fields, end):
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(j.end, f)), err_msg=f)
    assert int(traj.done.sum()) > 0 and bool(won.any()) and bool(traj.mask.any())


def test_league_update_matches_jax(jax_run):
    """One league train step (epochs=1) from the same params, state and
    draws: the metrics, and the Adam step within 5e-2 of optax's wherever
    JAX's gradient is not within 5e-2 of its max of 0."""
    scripted, j = jax_run
    params = port_params(j.jp)
    before = {k: v.clone() for k, v in params.items()}
    opt = P.make_optimizer(params, j.cfg)
    step = L.make_league_train_step(j.pw, j.cfg, scripted_opponent=scripted)
    end, m = step(params, port_params(j.jo), opt, host_state(j.jst), noise=j.noise)
    jm = j.metrics
    assert int(m["episodes"]) == int(jm["episodes"]) > 0
    assert float(m["learner_win_rate"]) == pytest.approx(float(jm["learner_win_rate"]), abs=1e-6)
    assert 0.0 <= float(m["learner_win_rate"]) <= 1.0
    assert abs(float(m["loss"]) - float(jm["loss"])) / (abs(float(jm["loss"])) + 1e-6) < 2e-2
    for k in ("v_loss", "entropy"):
        assert abs(float(m[k]) - float(jm[k])) < 5e-2, k
    assert m["unroll_ms"] > 0 and m["update_ms"] > 0
    for f, x in zip(end._fields, end):
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(j.step_end, f)), err_msg=f)
    for k in j.jp:
        got = (params[k].detach() - before[k]).numpy()
        want = np.asarray(j.params[k]) - np.asarray(j.jp[k])
        g = np.abs(np.asarray(j.grads[k]))
        keep = g >= 5e-2 * g.max()
        assert rel_err(got[keep], want[keep]) < 5e-2, (k, rel_err(got[keep], want[keep]))


def test_league_unroll_packs_once_per_state(ww_pair):
    """The pipeline forward (the host build of K2's code) over a league
    unroll that alternates the learner's and the opponent's parameters
    every step packs twice: once per parameter state, where a single
    cache slot would pack before almost every call."""
    pw = ww_pair.port
    cfg = P.PPOConfig(horizon=T, epochs=1, net=N.NetConfig(hidden=64, arch="attn"))
    d = FZ.dims_for(pw, cfg.net)
    assert FZ.supports(pw, cfg.net)
    gen = torch.Generator().manual_seed(0)
    mk = lambda: N.init_params(gen, N.obs_dim(pw), N.action_space(pw), cfg.net, pw,  # noqa: E731
                               device="cpu")
    params, opp = mk(), mk()
    calls = []

    def host_apply(p, obs):
        calls.append(p is params)
        logits, value = FZ.host_forward(d, obs.reshape(-1, d.F).contiguous(), p)
        return logits.reshape(obs.shape[:-1] + (d.A,)), value.reshape(obs.shape[:-1])

    unroll = L.make_league_unroll(pw, cfg, apply_fn=host_apply)
    state = init_state(pw, B, N_SEATS, np.arange(B, dtype=np.uint32), device="cpu")
    packs = FZ._packed.packs
    unroll(params, opp, state, torch.Generator().manual_seed(1))
    assert calls == [True, False] * T
    assert FZ._packed.packs - packs == 2


# ---------------------------------------------------------------------------
# run.main --league and checkpoints in both directions
# ---------------------------------------------------------------------------

LEAGUE_ARGV = ["--device", "cpu", "--arch", "attn", "--hidden", "32", "--batch", "8",
               "--horizon", "4", "--epochs", "1", "--eval-batch", "0", "--league",
               "--league-snapshot-every", "1"]


def test_run_main_league_both_arms(tmp_path, monkeypatch):
    drawn = []
    sample = L.League.sample_opponent

    def spy(self, rng):
        out = sample(self, rng)
        drawn.append(out[0])
        return out

    monkeypatch.setattr(L.League, "sample_opponent", spy)
    d = tmp_path / "league"
    params, events = run_main(LEAGUE_ARGV + ["--updates", "4", "--league-dir", str(d)])
    assert L.League.ANCHOR_ID in drawn and any(i >= 0 for i in drawn), drawn
    train = [e for e in events if e["event"] == "train"]
    assert len(train) == 1 and train[0]["update"] == 4
    assert train[0]["pool_size"] == 5 and train[0]["opponent"] == drawn[-1]
    for k in ("loss", "v_loss", "entropy", "learner_win_rate", "episodes"):
        assert np.isfinite(train[0][k]), k
    snaps = sorted(p.name for p in d.glob("*.npz"))
    assert snaps == [f"snap_u{u:05d}.npz" for u in range(1, 5)]
    last, cfg = N.load_policy(str(d / "snap_u00004.npz"), device="cpu")
    assert cfg == N.NetConfig(hidden=32, arch="attn")
    assert all(torch.equal(last[k], params[k].detach()) for k in params)
    assert json.loads((d / "snap_u00004.tree.json").read_text())["meta"] == {"attn_heads": 1}


def test_run_main_league_without_anchor(tmp_path):
    _, events = run_main(LEAGUE_ARGV + ["--updates", "2", "--no-league-anchor"])
    train = [e for e in events if e["event"] == "train"][-1]
    assert train["opponent"] >= 0 and train["pool_size"] == 3


def test_checkpoints_cross_both_ways(tmp_path, ww_pair):
    """The port's --league-dir snapshots load in the JAX matchup_table (and
    equal what the port wrote), and JAX save_tree snapshots load in the
    port's matchup_table."""
    d = tmp_path / "port"
    run_main(LEAGUE_ARGV + ["--updates", "2", "--league-dir", str(d)])
    paths = [str(d / "snap_u00001.npz"), str(d / "snap_u00002.npz")]
    jcfg = JN.NetConfig(hidden=32, arch="attn")
    jpc = JP.PPOConfig(net=jcfg)
    table = JE.matchup_table(ww_pair.jax, jpc, paths, 4, 6, N_SEATS, 3)
    assert list(table) == ["snap_u00001", "snap_u00002"]
    template, _, _ = JP.init_training(ww_pair.jax, jpc, jax.random.PRNGKey(0))
    from game_engine_tpu.utils.checkpoint import load_tree

    port_side, _ = N.load_policy(paths[1], device="cpu")
    jax_side = load_tree(paths[1], template)
    for k in port_side:
        np.testing.assert_array_equal(port_side[k].numpy(), np.asarray(jax_side[k]))

    jpaths = []
    for seed in (0, 1):
        _, jp = jax_params(ww_pair.jax, "attn", hidden=32, seed=seed)
        jpaths.append(str(tmp_path / f"jax_{seed}"))
        save_tree(jpaths[-1], jp, meta={"attn_heads": 1})
        back, _ = N.load_policy(jpaths[-1] + ".npz", device="cpu")
        for k in jp:
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(jp[k]))
    cfg = P.PPOConfig(net=N.NetConfig(hidden=32, arch="attn"))
    table = E.matchup_table(ww_pair.port, cfg, [p + ".npz" for p in jpaths], 4, 6, N_SEATS,
                            3, device="cpu")
    assert list(table) == ["jax_0", "jax_1"]
    assert all(0.0 <= v <= 1.0 for row in table.values() for v in row.values())
