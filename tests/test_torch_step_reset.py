"""ST's fused entry (csrc/rollout.cu ge_step_reset: the unroll's step, its
terminal rewards and the reset in one launch) and ST's block body at other
block sizes, on the CPU: the g++ build of the kernel's block body
(core/step_kernel.py host_step_reset, host_step, host_reset_done,
host_bot_actions) against make_step, terminal_rewards_plain and
reset_where_done, bit for bit, on every catalog game, to episode ends, on
born-done rooms, at 40 and 72 seats and on the 78-phase game; against the
JAX package's jitted step, terminal rewards and where(done) reset on two
games; and the unrolls that take it (ppo, league, the evaluators, the
policy loop) on CPU tensors against the loops of plain calls they ran
before. The kernel itself runs only on a GPU (chip_smoke.py's
engine_step phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.engine import init_state_like as jax_init_state_like
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch import bench
from game_engine_tpu_torch.core import engine as E
from game_engine_tpu_torch.core.entry_args import new_state
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.core.step import make_step
from game_engine_tpu_torch.core.step_kernel import (
    host_bot_actions,
    host_reset_done,
    host_step,
    host_step_reset,
    kernel_step_reset,
)
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import evaluate as EV
from game_engine_tpu_torch.train import league as L
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.train import run as R
from game_engine_tpu_torch.utils.step_cases import odd_actions
from tests.test_torch_engine import born_done_game
from tests.test_torch_kernel_host import long_pair, wide_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import assert_same_state, builtin_pair, catalog_games, lowered_game
from tests.test_torch_step_kernel import assert_states_equal, room_sizes


def plain_step_reset(lw, state, actions):
    """The composition the fused entry replaces: make_step, the terminal
    rewards of the stepped state, the where(done) reset."""
    nxt = make_step(lw)(state, actions)
    ended = nxt.done & ~state.done
    reward = E.terminal_rewards_plain(lw, nxt, ended)
    return E.reset_where_done(lw, nxt), ended, nxt.winner, reward


def assert_fused_equal(got, ref, what: str) -> None:
    state, ended, winner, reward = got
    rstate, rended, rwinner, rreward = ref
    assert_states_equal(state, rstate, what)
    for name, x, y in (("ended", ended, rended), ("winner", winner, rwinner),
                       ("reward", reward.view(torch.int32), rreward.view(torch.int32))):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f"{what}: {name}"


def hold_fused(lw, n, steps: int, seed: int, rooms_per_block: int = 3) -> dict:
    """`steps` fused steps of rooms of sizes `n` on odd_actions of the bots',
    against plain_step_reset, the result written into the spare state of
    two steps before (as the unrolls pass it). Returns what the run met."""
    rng = np.random.default_rng(seed)
    B = len(n)
    seeds = rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    state = init_state(lw, B, torch.as_tensor(n, dtype=torch.int32), seeds, device="cpu")
    met = {"ended": 0, "paid": 0, "born_done": int(state.done.sum())}
    spare = None
    for t in range(steps):
        actions = odd_actions(lw, host_bot_actions(lw, state, rooms_per_block), rng)
        before = GameState(*(x.clone() for x in state))
        got = host_step_reset(lw, state, actions, rewards=True, out=spare,
                              rooms_per_block=rooms_per_block)
        ref = plain_step_reset(lw, state, actions)
        assert_fused_equal(got, ref, f"t={t}")
        assert_states_equal(state, before, f"the input t={t}")
        met["ended"] += int(got[1].sum())
        met["paid"] += int((got[3] != 0).sum())
        spare, state = (state if t else None), got[0]
    return met


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_fused_matches_plain(game):
    lw = builtin_pair(game).port
    rng = np.random.default_rng(len(game) + 7)
    hold_fused(lw, room_sizes(lw, 7, rng), 20, seed=sum(map(ord, game)) + 1)


@pytest.mark.parametrize("name,seed", [("werewolf", 0), ("werewolf", 1),
                                       ("two-truths-and-a-lie", 2), ("bounty-arena", 3),
                                       ("cult-of-the-depths", 4)])
def test_fused_pays_rewards_at_episode_ends(name, seed):
    """Long enough that rooms end (team and score rewards paid), restart
    and end again."""
    lw = lowered_game(name).port
    met = hold_fused(lw, np.full(7, min(6, lw.P)), 100, seed)
    assert met["ended"] > 0 and met["paid"] > 0


def test_fused_born_done_rooms():
    lw = born_done_game().port
    met = hold_fused(lw, np.array([4, 5, 4, 6, 5, 4, 6]), 20, seed=5)
    assert met["born_done"] > 0


@pytest.mark.parametrize("case,n,steps", [("werewolf-40", [37, 40, 33], 30),
                                          ("werewolf-72", [72, 65], 20),
                                          ("long", [8, 6, 7, 8, 5], 90)])
def test_fused_past_the_old_bounds(case, n, steps):
    """The wide build (seat sets of 8 words) at 40 and 72 seats and the
    78-phase game."""
    pair = {"werewolf-40": lambda: wide_pair(40), "werewolf-72": lambda: wide_pair(72),
            "long": long_pair}[case]()
    hold_fused(pair.port, np.array(n), steps, seed=len(case), rooms_per_block=2)


@pytest.mark.parametrize("rooms_per_block", [1, 2, 4, 5, 16])
@pytest.mark.parametrize("B", [1, 4, 6, 17])
def test_block_body_at_block_boundaries(rooms_per_block, B):
    """The block body's staging at block sizes around B (a block of one
    room, a last block part full, more rooms a block than B): the fused
    entry, the step with a keep mask, the reset (whose blocks with no done
    room copy their rooms through) and the bots."""
    lw = lowered_game("werewolf").port
    rng = np.random.default_rng(B * 31 + rooms_per_block)
    state = init_state(lw, B, torch.as_tensor(room_sizes(lw, B, rng), dtype=torch.int32),
                       np.arange(B, dtype=np.uint32) * 5 + B, device="cpu")
    step = make_step(lw)
    for t in range(40):
        bots = host_bot_actions(lw, state, rooms_per_block)
        assert torch.equal(bots, E.scripted_actions(lw, state)), f"bots t={t}"
        actions = odd_actions(lw, bots, rng)
        assert_fused_equal(host_step_reset(lw, state, actions, True,
                                           rooms_per_block=rooms_per_block),
                           plain_step_reset(lw, state, actions), f"fused t={t}")
        keep = torch.as_tensor(rng.random(B) < 0.8)
        got, ended = host_step(lw, state, actions, keep, rooms_per_block)
        ref = E._where_rooms(keep, step(state, actions), state)
        assert_states_equal(got, ref, f"step t={t}")
        assert torch.equal(ended, ref.done & ~state.done)
        state = host_reset_done(lw, got, rooms_per_block)
        assert_states_equal(state, E.reset_where_done(lw, got), f"reset t={t}")


@pytest.mark.parametrize("name,n", [("werewolf", 6), ("cult-of-the-depths", 6)])
def test_fused_matches_the_jax_unroll_body(name, n):
    """The g++ fused entry against the JAX unroll's body on the same odd
    actions: its jitted step, terminal_rewards of the stepped state and the
    init_state_like + where(done) reset, every field, ended, the winner
    and the rewards exact."""
    pair = lowered_game(name)
    B = 8
    seeds = np.arange(B, dtype=np.uint32) + 23
    jeng = JaxBatchedEngine(pair.jax)
    j_rewards = jax.jit(lambda s, e: JP.terminal_rewards(pair.jax, s, e))
    jst = jax_init_state(pair.jax, B, n, seeds)
    st = init_state(pair.port, B, n, seeds, device="cpu")
    rng = np.random.default_rng(9)
    paid = 0
    for t in range(60):
        actions = odd_actions(pair.port, host_bot_actions(pair.port, st), rng)
        jnext = jeng.step(jst, jnp.asarray(actions.numpy()))
        jended = jnext.done & ~jst.done
        jreward = np.asarray(j_rewards(jnext, jended))
        fresh = jax_init_state_like(pair.jax, jnext)
        jst = jax.tree.map(lambda f, o: jnp.where(
            jnext.done.reshape((-1,) + (1,) * (o.ndim - 1)), f, o), fresh, jnext)
        st, ended, winner, reward = host_step_reset(pair.port, st, actions, rewards=True)
        assert_same_state(jst, st)
        np.testing.assert_array_equal(ended.numpy(), np.asarray(jended), err_msg=f"t={t}")
        np.testing.assert_array_equal(winner.numpy(), np.asarray(jnext.winner))
        np.testing.assert_array_equal(reward.numpy(), jreward, err_msg=f"t={t}")
        paid += int((reward != 0).sum())
    assert paid > 0


def test_step_and_reset_on_cpu_is_the_composition():
    """engine.step_and_reset on CPU tensors composes the plain functions,
    with and without rewards (and leaves `out` alone)."""
    lw = lowered_game("werewolf").port
    st = init_state(lw, 6, 6, np.arange(6, dtype=np.uint32), device="cpu")
    spare = new_state(lw, 6, "cpu")
    for t in range(30):
        a = E.scripted_actions(lw, st)
        res = E.step_and_reset(lw, st, a.to(torch.int64), rewards=t % 2 == 0, out=spare)
        ref = plain_step_reset(lw, st, a)
        assert_states_equal(res.state, ref[0], f"t={t}")
        assert torch.equal(res.ended, ref[1]) and torch.equal(res.winner, ref[2])
        assert (res.reward is None) if t % 2 else torch.equal(res.reward, ref[3])
        st = res.state


def test_fused_wrapper_checks_raise():
    """No launch on bad input: the CUDA wrapper refuses CPU tensors; the
    host entry a wrong dtype, a spare state sharing a field with the input
    or of another batch."""
    lw = lowered_game("werewolf").port
    st = init_state(lw, 3, 6, 0, device="cpu")
    a = host_bot_actions(lw, st)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_step_reset(lw, st, a)
    with pytest.raises(ValueError, match="actions must be"):
        host_step_reset(lw, st, a.to(torch.int64))
    with pytest.raises(ValueError, match="sharing no field"):
        host_step_reset(lw, st, a, out=st)
    with pytest.raises(ValueError, match="sharing no field"):
        host_step_reset(lw, st, a, out=new_state(lw, 3, "cpu")._replace(present=st.present))
    with pytest.raises(ValueError, match="sharing no field"):
        host_step_reset(lw, st, a, out=GameState(*(t.clone() for t in st))._replace(
            present=st.present))
    with pytest.raises(ValueError, match="same rooms"):
        host_step_reset(lw, st, a, out=new_state(lw, 4, "cpu"))
    with pytest.raises(ValueError, match="field seed"):
        host_step_reset(lw, st, a, out=new_state(lw, 3, "cpu")._replace(
            seed=torch.zeros(3, dtype=torch.int32)))


# -- the unrolls that take it, on CPU tensors, against their earlier loops ------

def tiny_params(lw, hidden: int = 16, seed: int = 0):
    cfg = N.NetConfig(hidden=hidden, layers=1)
    return N.init_params(torch.Generator().manual_seed(seed), N.obs_dim(lw),
                         N.action_space(lw), cfg, lw, device="cpu"), cfg


def old_step(lw, state, actions):
    """An unroll's step as the paths took it before: engine_step, then the
    reset of the stepped state."""
    nxt, ended = E.engine_step(lw, state, actions)
    return nxt, ended, E.reset_done(lw, nxt)


def test_league_unroll_on_cpu_equals_its_plain_loop():
    lw = lowered_game("werewolf").port
    params, cfg = tiny_params(lw)
    opp, _ = tiny_params(lw, seed=1)
    pcfg = P.PPOConfig(horizon=8, net=cfg)
    start = init_state(lw, 6, 6, np.arange(6, dtype=np.uint32) + 5, device="cpu")
    state, traj, won = L.make_league_unroll(lw, pcfg)(params, opp, start,
                                                     torch.Generator().manual_seed(2))
    apply_fn = P.make_apply_fn(lw, pcfg)
    gen, st, rows, wins = torch.Generator().manual_seed(2), start, [], []
    with torch.no_grad():
        for _ in range(pcfg.horizon):
            obs, legal, am = N.observe_all(lw, st)
            a, logp, v, _ = N.sample_actions(lw, params, st, cfg, obs=obs, apply_fn=apply_fn,
                                             generator=gen, legal=legal)
            oa, _, _, _ = N.sample_actions(lw, opp, st, cfg, obs=obs, apply_fn=apply_fn,
                                           generator=gen, legal=legal)
            ctrl = L.learner_controls(lw, st)
            actions = torch.where(am & ctrl, a, torch.where(am, oa, 0))
            nxt, ended, st = old_step(lw, st, actions)
            reward = P.terminal_rewards(lw, nxt, ended)
            wins.append(ended & (ctrl & (reward > 0)).any(1))
            rows.append(P.Rollout(obs, actions, logp, v, reward, ended, am & ctrl, legal))
    ref = P.Rollout(*(torch.stack(xs) for xs in zip(*rows)))
    assert_states_equal(state, st, "the league unroll's state")
    for name, x, y in zip(P.Rollout._fields, traj, ref):
        assert torch.equal(x, y), name
    assert torch.equal(won, torch.stack(wins))


def test_evaluators_and_policy_loop_on_cpu_equal_their_plain_loops():
    """evaluate.make_vs, run.make_eval and bench.policy_steps on CPU
    tensors count the wins, episode ends and state of the loops of
    engine_step and reset_done they ran before."""
    lw = lowered_game("werewolf").port
    params, cfg = tiny_params(lw)
    pcfg = P.PPOConfig(net=cfg)
    start = init_state(lw, 6, 6, np.arange(6, dtype=np.uint32) + 9, device="cpu")
    steps = 40

    def vs_loop(gen):
        st, wins, dones = start, 0, 0
        with torch.no_grad():
            for _ in range(steps):
                obs, legal, am = N.observe_all(lw, st)
                a1 = N.sample_actions(lw, params, st, cfg, obs=obs, generator=gen, legal=legal)[0]
                a2 = N.sample_actions(lw, params, st, cfg, obs=obs, generator=gen, legal=legal)[0]
                side = P.team_masks(lw, st)
                nxt, ended, st = old_step(lw, st, torch.where(am & side, a1,
                                                             torch.where(am, a2, 0)))
                wins += int((ended & (nxt.winner == 1)).sum())
                dones += int(ended.sum())
        return wins, dones

    got = EV.make_vs(lw, pcfg, steps)(params, params, start, torch.Generator().manual_seed(4))
    assert got == vs_loop(torch.Generator().manual_seed(4)) and got[1] > 0

    def eval_loop(gen):
        st, wins, dones = start, 0, 0
        with torch.no_grad():
            for _ in range(steps):
                obs, legal, am = N.observe_all(lw, st)
                la = N.sample_actions(lw, params, st, cfg, obs=obs, generator=gen, legal=legal)[0]
                sa = E.bot_actions(lw, st)
                side = P.team_masks(lw, st)
                nxt, ended, st = old_step(lw, st, torch.where(am & side, la,
                                                             torch.where(am, sa, 0)))
                wins += int((ended & (nxt.winner == 1)).sum())
                dones += int(ended.sum())
        return wins, dones

    got = R.make_eval(lw, pcfg, True, steps)(params, start, torch.Generator().manual_seed(6))
    assert got == eval_loop(torch.Generator().manual_seed(6))

    state, eps = bench.policy_steps(lw, params, cfg, start, steps,
                                    torch.Generator().manual_seed(8))
    gen, st, n_eps = torch.Generator().manual_seed(8), start, 0
    with torch.no_grad():
        for _ in range(steps):
            obs, legal, am = N.observe_all(lw, st)
            a = N.sample_actions(lw, params, st, cfg, obs=obs, generator=gen, legal=legal,
                                 actor=am)[0]
            _, ended, st = old_step(lw, st, a)
            n_eps += int(ended.sum())
    assert_states_equal(state, st, "the policy loop's state")
    assert int(eps) == n_eps


def test_new_state_and_the_state_checks():
    """entry_args.new_state: every field of the GameState dtypes and the
    game's shapes, contiguous, no two overlapping; checked_state takes a
    state it checked (or an entry made) without a second pass, yet checks a
    state rebuilt around it (a _replace) again and names a bad field."""
    from game_engine_tpu_torch.core import entry_args as EA

    lw = lowered_game("werewolf").port
    st = init_state(lw, 5, 6, np.arange(5, dtype=np.uint32), device="cpu")
    fresh = new_state(lw, 5, "cpu")
    spans = []
    for name, x, y in zip(GameState._fields, fresh, st):
        assert x.dtype == y.dtype and x.shape == y.shape and x.is_contiguous(), name
        spans.append((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    checked = EA.checked_state(lw, st, "cpu", "x")
    assert checked is st and EA.checked_state(lw, st, "cpu", "x") is st
    assert EA.state_addresses(lw, st, "cpu")[5] == st.present.data_ptr()
    with pytest.raises(ValueError, match="field phase"):
        EA.checked_state(lw, st._replace(phase=st.phase.to(torch.int64)), "cpu", "x")
    with pytest.raises(ValueError, match="CUDA tensors"):
        EA.checked_state(lw, st, "cuda", "the step")
    got, _ = host_step(lw, st, host_bot_actions(lw, st))
    assert EA.checked_state(lw, got, "cpu", "x") is got  # made here: remembered


def test_checked_states_are_held_weakly_and_the_least_recently_used_dropped():
    """checked_state's memory of the states it checked holds none of their
    tensors (a state the caller drops is freed), keeps a state in use while
    _KNOWN_MAX others pass through, and checks again a state whose `present`
    it knows but whose other fields are new."""
    import gc
    import weakref

    from game_engine_tpu_torch.core import entry_args as EA

    lw = lowered_game("werewolf").port
    st = init_state(lw, 3, 6, np.arange(3, dtype=np.uint32), device="cpu")
    EA.checked_state(lw, st, "cpu", "x")
    freed = weakref.ref(st.nums)
    st = st._replace(nums=st.nums.clone())
    gc.collect()
    assert freed() is None  # the old nums went with the caller's last reference
    assert EA._known(lw, st, "cpu") is None  # present known, nums new: checked again
    EA.checked_state(lw, st, "cpu", "x")
    others = [init_state(lw, 3, 6, np.arange(3, dtype=np.uint32) + k, device="cpu")
              for k in range(2 * EA._KNOWN_MAX)]
    for other in others:
        EA.checked_state(lw, other, "cpu", "x")
        assert EA._known(lw, st, "cpu") is not None  # used a call ago: kept
    assert len(EA._KNOWN) <= EA._KNOWN_MAX
    assert EA._known(lw, others[0], "cpu") is None  # least recently used: dropped


def test_check_game_holds_a_game_to_the_step_entrys_block():
    """check_game accepts a game only where the engine step entry's block
    (K1's words and its rooms' staged fields) fits one warp: werewolf's
    room grows as P^2 (its pdict), and the largest seats accepted, 144, fit
    ST's one-warp block while 145 are refused by ST's bound, though K1's
    block alone holds up to 158."""
    from game_engine_tpu_torch.core.rollout_kernel import MIN_THREADS, block_size, check_game
    from game_engine_tpu_torch.gamespec.compile import GameConfig, compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    def werewolf(seats):
        return lower(compile_game(load_builtin("werewolf"), GameConfig(max_players=seats)))

    largest = werewolf(144)
    check_game(largest)
    size = block_size(largest, MIN_THREADS)
    assert size["st_threads"] == MIN_THREADS
    assert size["shared_bytes"] < size["st_shared_bytes"] <= size["max_shared_bytes"]
    past = werewolf(145)
    size = block_size(past, MIN_THREADS)
    assert size["threads"] == MIN_THREADS and size["st_threads"] == 0
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory for an engine step "
                                         r"block.*<= 232448"):
        check_game(past)
    assert block_size(werewolf(158), MIN_THREADS)["threads"] == MIN_THREADS
