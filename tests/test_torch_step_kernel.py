"""ST, the engine step entry (csrc/rollout.cu ge_step, ge_reset_done and
ge_bots), on the CPU: the same entries built with g++ (csrc/rollout_host.cpp,
core/step_kernel.py host_step, host_reset_done and host_bot_actions)
against the plain make_step, reset_where_done and scripted_actions, bit for
bit on every field, on every catalog game, with actions no scripted bot
emits, keep masks, born-done rooms, 40 and 72 seats and the 78-phase game;
on two games against the JAX package's jitted step; and the entry points
that route CUDA tensors through ST keep their CPU behaviour. The kernel
itself runs only on a GPU (chip_smoke.py's engine_step phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.engine import init_state_like as jax_init_state_like
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu_torch.core import engine as E
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.core.step import make_step
from game_engine_tpu_torch.core.step_kernel import (
    count_step,
    host_bot_actions,
    host_reset_done,
    host_step,
    kernel_bot_actions,
    kernel_reset_done,
    kernel_step,
)
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.utils.step_cases import odd_actions
from tests.test_torch_engine import born_done_game
from tests.test_torch_kernel_host import long_pair, wide_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import assert_same_state, builtin_pair, catalog_games, lowered_game


def assert_states_equal(got: GameState, ref: GameState, what: str) -> None:
    bad = [f for f, x, y in zip(GameState._fields, got, ref)
           if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]
    assert not bad, f"{what}: fields differ: {bad}"


def hold_against_plain(lw, n, steps: int, seed: int, keep_share: float = 0.8,
                       reset_every: int = 1) -> dict:
    """`steps` steps of rooms of sizes `n` from seeds made from `seed`: the
    bots, a step on odd_actions with a keep mask, then (every
    `reset_every`-th step, so that done rooms are stepped in between) the
    reset, each through the g++ entries and the plain functions, every
    field equal. Returns what the run met."""
    rng = np.random.default_rng(seed)
    B = len(n)
    seeds = rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    state = init_state(lw, B, torch.as_tensor(n, dtype=torch.int32), seeds, device="cpu")
    step = make_step(lw)
    met = {"ended": 0, "done_stepped": 0, "kept_out": 0, "reset": 0}
    for t in range(steps):
        bots = host_bot_actions(lw, state)
        assert torch.equal(bots, E.scripted_actions(lw, state)), f"bots t={t}"
        actions = odd_actions(lw, bots, rng)
        keep = torch.as_tensor(rng.random(B) < keep_share)
        before = GameState(*(x.clone() for x in state))
        got, ended = host_step(lw, state, actions, keep)
        ref = E._where_rooms(keep, step(state, actions), state)
        assert_states_equal(got, ref, f"step t={t}")
        assert_states_equal(state, before, f"the step's input t={t}")
        assert ended.dtype == torch.bool and torch.equal(ended, ref.done & ~state.done)
        met["ended"] += int(ended.sum())
        met["done_stepped"] += int((state.done & keep).sum())
        met["kept_out"] += int((~keep).sum())
        state = got
        if t % reset_every == reset_every - 1:
            state = host_reset_done(lw, got)
            assert_states_equal(state, E.reset_where_done(lw, got), f"reset t={t}")
            met["reset"] += int(got.done.sum())
    return met


def room_sizes(lw, B: int, rng) -> np.ndarray:
    lo = min(lw.game.spec.declaration.min_players or 4, lw.P)
    return rng.integers(lo, lw.P + 1, B)


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_entries_match_plain(game):
    lw = builtin_pair(game).port
    rng = np.random.default_rng(len(game))
    met = hold_against_plain(lw, room_sizes(lw, 8, rng), 24, seed=sum(map(ord, game)))
    assert met["kept_out"] > 0


@pytest.mark.parametrize("name,seed", [("werewolf", 0), ("werewolf", 1), ("werewolf", 2),
                                       ("two-truths-and-a-lie", 3), ("assassins", 4)])
def test_entries_match_plain_from_several_seeds_to_episode_ends(name, seed):
    """Long enough that rooms finish, are stepped while done and reset."""
    lw = lowered_game(name).port
    met = hold_against_plain(lw, np.full(8, min(6, lw.P)), 90, seed, keep_share=0.95,
                             reset_every=3)
    assert met["ended"] > 0 and met["done_stepped"] > 0 and met["reset"] > 0


def test_entries_born_done_rooms():
    lw = born_done_game().port
    met = hold_against_plain(lw, np.array([4, 5, 4, 6, 5, 4, 6, 5]), 30, seed=5)
    assert met["done_stepped"] > 0 and met["reset"] > 0


@pytest.mark.parametrize("case,n,steps", [("werewolf-40", [37, 40, 33], 40),
                                          ("werewolf-72", [72, 65], 30),
                                          ("long", [8, 6, 7, 8], 120)])
def test_entries_past_the_old_bounds(case, n, steps):
    """The wide build (seat sets of 8 words) at 40 and 72 seats and the
    78-phase game, as test_torch_kernel_host.py holds K1's body there."""
    pair = {"werewolf-40": lambda: wide_pair(40), "werewolf-72": lambda: wide_pair(72),
            "long": long_pair}[case]()
    hold_against_plain(pair.port, np.array(n), steps, seed=len(case), keep_share=0.9)


@pytest.mark.parametrize("name,n", [("werewolf", 6), ("two-truths-and-a-lie", 4)])
def test_entries_match_jax_step(name, n):
    """The g++ entries against the JAX package's jitted step (the shapes of
    test_torch_step.py's comparison) and its init_state_like reset, on the
    same odd actions."""
    pair = lowered_game(name)
    B = 8
    seeds = np.arange(B, dtype=np.uint32) + 11
    jeng = JaxBatchedEngine(pair.jax)
    jst = jax_init_state(pair.jax, B, n, seeds)
    st = init_state(pair.port, B, n, seeds, device="cpu")
    rng = np.random.default_rng(7)
    ended_any = False
    for t in range(40):
        bots = host_bot_actions(pair.port, st)
        np.testing.assert_array_equal(bots.numpy(), np.asarray(jeng.bot_actions(jst)))
        actions = odd_actions(pair.port, bots, rng)
        jnext = jeng.step(jst, jnp.asarray(actions.numpy()))
        st, ended = host_step(pair.port, st, actions)
        assert_same_state(jnext, st)
        np.testing.assert_array_equal(ended.numpy(),
                                      np.asarray(jnext.done & ~jst.done), err_msg=f"t={t}")
        ended_any |= bool(ended.any())
        fresh = jax_init_state_like(pair.jax, jnext)
        jst = jax.tree.map(lambda f, o: jnp.where(
            jnext.done.reshape((-1,) + (1,) * (o.ndim - 1)), f, o), fresh, jnext)
        st = host_reset_done(pair.port, st)
        assert_same_state(jst, st)
    assert ended_any


def test_entries_take_the_seed_as_uint32():
    """Seeds at 0, 2**31 and 2**32 - 1: the reset's splitmix32(seed ^
    0xDECAF000) and the bots' streams, and the seed out of the step as it
    came in (an int64 holding a uint32)."""
    lw = lowered_game("werewolf").port
    seeds = torch.tensor([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDECAF000, 1, 2, 3])
    st = init_state(lw, 8, 6, seeds, device="cpu")
    st = st._replace(done=torch.ones(8, dtype=torch.bool))
    assert torch.equal(host_bot_actions(lw, st), E.scripted_actions(lw, st))
    got, _ = host_step(lw, st, torch.zeros((8, lw.P), dtype=torch.int32))
    assert torch.equal(got.seed, seeds) and got.seed.dtype == torch.int64
    assert_states_equal(host_reset_done(lw, st), E.reset_where_done(lw, st), "reset")


def test_choosers_keep_the_cpu_path():
    """engine_step, reset_done and bot_actions on CPU tensors are the plain
    functions; BatchedEngine.step's keep mask leaves the other rooms as
    they were."""
    lw = lowered_game("werewolf").port
    eng = E.BatchedEngine(lw, "cpu")
    st = eng.init(6, 6, np.arange(6, dtype=np.uint32))
    for _ in range(5):
        a = eng.bot_actions(st)
        assert torch.equal(a, E.scripted_actions(lw, st))
        new, ended = E.engine_step(lw, st, a.to(torch.int64))  # converted as make_step does
        ref = make_step(lw)(st, a)
        assert_states_equal(new, ref, "engine_step")
        assert torch.equal(ended, ref.done & ~st.done)
        keep = torch.tensor([True, False, True, False, True, False])
        kept = eng.step(st, a, keep=keep)
        assert_states_equal(kept, E._where_rooms(keep, ref, st), "keep")
        st = E.reset_done(lw, new)
    done = st._replace(done=torch.ones(6, dtype=torch.bool))
    assert_states_equal(P.reset_done(lw, done), E.reset_where_done(lw, done), "ppo.reset_done")


def test_unroll_on_cpu_is_unchanged():
    """make_unroll on CPU tensors takes the same trajectory as the loop it
    ran before ST (make_step, done & ~done, the where(done) reset)."""
    lw = lowered_game("werewolf").port
    cfg = P.PPOConfig(horizon=6, net=N.NetConfig(hidden=16, layers=1))
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw),
                           N.action_space(lw), cfg.net, lw, device="cpu")
    start = init_state(lw, 8, 6, np.arange(8, dtype=np.uint32), device="cpu")
    state, traj = P.make_unroll(lw, cfg)(params, start, torch.Generator().manual_seed(3))

    gen, st, step, steps = torch.Generator().manual_seed(3), start, make_step(lw), []
    with torch.no_grad():
        for _ in range(cfg.horizon):
            obs = N.observe(lw, st)
            a, logp, v, legal = N.sample_actions(lw, params, st, cfg.net, obs=obs,
                                                 generator=gen)
            mask = P.actor_mask(lw, st)
            actions = torch.where(mask, a, 0)
            nxt = step(st, actions)
            ended = nxt.done & ~st.done
            reward = P.terminal_rewards(lw, nxt, ended)
            fresh = E.init_state_like(lw, nxt)
            st = GameState(*(torch.where(nxt.done.reshape((-1,) + (1,) * (o.dim() - 1)), f, o)
                             for f, o in zip(fresh, nxt)))
            steps.append(P.Rollout(obs, actions, logp, v, reward, ended, mask, legal))
    ref = P.Rollout(*(torch.stack(xs) for xs in zip(*steps)))
    assert_states_equal(state, st, "the unroll's state")
    for name, x, y in zip(P.Rollout._fields, traj, ref):
        assert torch.equal(x, y), name


def test_count_step_counts_the_interpreters_operations():
    lw = lowered_game("werewolf").port
    st = init_state(lw, 4, 8, np.arange(4, dtype=np.uint32), device="cpu")
    atoms = 0
    for _ in range(12):  # past the start phases, which read no predicate
        a = host_bot_actions(lw, st)
        counts = count_step(lw, st, a)
        assert counts["int_ops"] == (counts["atoms"] + counts["node_ops"]
                                     + counts["state_writes"] + 9 * counts["hashes"])
        assert count_step(lw, st, a) == counts  # reset between runs
        atoms += counts["atoms"]
        st, _ = host_step(lw, st, a)
    assert atoms > 0


def test_wrapper_checks_raise():
    """No silent CPU fallback and no launch on a bad input: the CUDA
    wrappers refuse CPU tensors, the host entries a wrong dtype or shape,
    and the choosers a device that is neither."""
    lw = lowered_game("werewolf").port
    st = init_state(lw, 2, 6, 0, device="cpu")
    a = host_bot_actions(lw, st)
    for call in (lambda: kernel_step(lw, st, a), lambda: kernel_reset_done(lw, st),
                 lambda: kernel_bot_actions(lw, st)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="actions must be"):
        host_step(lw, st, a.to(torch.int64))
    with pytest.raises(ValueError, match="actions must be"):
        host_step(lw, st, a[:, :3])
    with pytest.raises(ValueError, match="keep must be"):
        host_step(lw, st, a, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="field nums"):
        host_step(lw, st._replace(nums=st.nums.to(torch.int64)), a)
    with pytest.raises(ValueError, match="field strs has shape"):
        host_reset_done(lw, st._replace(strs=st.strs[:, :, :1]))
    with pytest.raises(ValueError):
        host_bot_actions(builtin_pair("potlatch").port, st)
    meta = GameState(*(torch.empty_like(t, device="meta") for t in st))
    for call in (lambda: E.engine_step(lw, meta, a), lambda: E.reset_done(lw, meta),
                 lambda: E.bot_actions(lw, meta)):
        with pytest.raises(ValueError, match="unsupported device meta"):
            call()
