"""OB, the observation entry, and SA, the sampling entry (csrc/observe.cu
ob_observe, ob_rewards and ob_sample), on the CPU: the same bodies built
with g++ (csrc/observe_host.cpp, policies/obs_kernel.py host_observe,
host_rewards and host_sample) against the plain observe_plain,
legal_action_mask_plain, actor_mask_plain, ppo.terminal_rewards_plain
and sample_actions_plain, bit for bit (logp within 1e-6), on every catalog
game along an ST unroll with actions no bot emits, on born-done rooms, at
40 and 72 seats and on the 78-phase game; the port's plain functions
against the JAX package's, exact, on three games; and the routed entry
points keep their CPU behaviour. The kernels themselves run only on a GPU
(chip_smoke.py's observe_step phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch.core import engine as E
from game_engine_tpu_torch.core.rollout_kernel import host_rollout
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.core.step import make_step
from game_engine_tpu_torch.core.step_kernel import host_bot_actions, host_reset_done, host_step
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.policies.obs_kernel import (
    host_observe,
    host_rewards,
    host_sample,
    kernel_observe,
    kernel_rewards,
    kernel_sample,
)
from game_engine_tpu_torch.policies.serve import first_argmax
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.utils.step_cases import odd_actions
from tests.test_torch_engine import born_done_game
from tests.test_torch_kernel_host import long_pair, wide_pair
from tests.test_torch_net import host_state, jax_params, port_cfg, port_params, to_np
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import builtin_pair, catalog_games, lowered_game

TINY = float(torch.finfo(torch.float32).tiny)


_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def bits(t: torch.Tensor) -> torch.Tensor:
    """bf16 and f32 tensors as their bits, so that equality is bit for bit."""
    return t.view(_BITS[t.dtype]) if t.dtype in _BITS else t


def assert_bitwise(got: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape, \
        f"{what}: {got.dtype} {tuple(got.shape)} vs {ref.dtype} {tuple(ref.shape)}"
    bad = (bits(got) != bits(ref)).nonzero()
    assert bad.shape[0] == 0, f"{what}: {bad.shape[0]} elements differ, first at {bad[0].tolist()}"


def hold_observe(lw, state: GameState, what: str) -> tuple:
    """host_observe against the plain functions on one state, both views."""
    for masked in (True, False):
        obs, legal, actor = host_observe(lw, state, masked)
        assert_bitwise(obs, N.observe_plain(lw, state, masked), f"{what} obs masked={masked}")
        assert_bitwise(legal, N.legal_action_mask_plain(lw, state), f"{what} legal")
        assert_bitwise(actor, P.actor_mask_plain(lw, state), f"{what} actor")
    return legal, actor


def plain_sample(logits, legal, u, actor):
    """sample_actions_plain's draw on the uniforms u, actor-masked."""
    a, logp = N.draw_plain(logits, legal, -torch.log(-torch.log(u.clamp_min(TINY))))
    return a, torch.where(actor, a, 0), logp


def hold_sample(logits, legal, u, actor, present, what: str) -> None:
    """host_sample against the plain draw: actions exact, logp within 1e-6;
    its greedy mode against PolicyBots.greedy's CPU body."""
    a, acting, logp = host_sample(logits, legal, u, actor)
    ra, racting, rlogp = plain_sample(logits, legal, u, actor)
    assert_bitwise(a, ra, f"{what} actions")
    assert_bitwise(acting, racting, f"{what} actor-masked actions")
    assert float((logp - rlogp).abs().max()) <= 1e-6, what
    g = host_sample(logits, legal, actor=present, mode="greedy")[1]
    ga = first_argmax(torch.where(legal, logits, -1e9)).to(torch.int32) + 1
    assert_bitwise(g, torch.where(legal.any(-1) & present, ga, 0), f"{what} greedy")


def sample_inputs(legal: torch.Tensor, rng) -> tuple:
    """f32 logits and uniforms from a numpy seed, ties forced: every third
    room's logits all equal and its uniforms equal along each row."""
    logits = torch.as_tensor(rng.standard_normal(legal.shape).astype(np.float32))
    u = torch.as_tensor(rng.random(legal.shape).astype(np.float32))
    logits[::3] = 0.25
    u[::3] = u[::3, :, :1]
    return logits, u


def unroll_against_plain(lw, n, steps: int, seed: int) -> dict:
    """`steps` steps of an ST unroll (host_step on odd_actions of the
    sampled actions, host_reset_done) from rooms of sizes `n`: at every
    state OB against the plain functions, SA on seeded logits, and OB's
    rewards of the stepped state. Returns what the run met."""
    rng = np.random.default_rng(seed)
    B = len(n)
    seeds = rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    state = init_state(lw, B, torch.as_tensor(n, dtype=torch.int32), seeds, device="cpu")
    met = {"actors": 0, "ended": 0, "done_seen": 0}
    for t in range(steps):
        legal, actor = hold_observe(lw, state, f"t={t}")
        logits, u = sample_inputs(legal, rng)
        hold_sample(logits, legal, u, actor, state.present, f"t={t}")
        _, acting, _ = host_sample(logits, legal, u, actor)
        actions = odd_actions(lw, torch.where(actor, acting, host_bot_actions(lw, state)), rng)
        nxt, ended = host_step(lw, state, actions)
        assert_bitwise(host_rewards(lw, nxt, ended), P.terminal_rewards_plain(lw, nxt, ended),
                       f"rewards t={t}")
        met["actors"] += int(actor.sum())
        met["ended"] += int(ended.sum())
        met["done_seen"] += int(state.done.sum())
        state = host_reset_done(lw, nxt) if t % 3 == 2 else nxt
    return met


def room_sizes(lw, B: int, rng) -> np.ndarray:
    lo = min(lw.game.spec.declaration.min_players or 4, lw.P)
    return rng.integers(lo, lw.P + 1, B)


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_entries_match_plain(game):
    lw = builtin_pair(game).port
    rng = np.random.default_rng(len(game))
    met = unroll_against_plain(lw, room_sizes(lw, 6, rng), 18, seed=sum(map(ord, game)))
    assert met["actors"] > 0


@pytest.mark.parametrize("name,seed", [("werewolf", 0), ("cult-of-the-depths", 1),
                                       ("bounty-arena", 2)])
def test_entries_match_plain_to_episode_ends(name, seed):
    """Long enough that rooms finish (team and score rewards paid) and are
    observed while done."""
    lw = lowered_game(name).port
    met = unroll_against_plain(lw, np.full(6, min(6, lw.P)), 90, seed)
    assert met["ended"] > 0 and met["done_seen"] > 0


def test_entries_born_done_rooms():
    lw = born_done_game().port
    met = unroll_against_plain(lw, np.array([4, 5, 4, 6, 5, 4]), 12, seed=5)
    assert met["done_seen"] > 0


@pytest.mark.parametrize("case,n,steps", [("werewolf-40", [37, 40, 33], 16),
                                          ("werewolf-72", [72, 65], 8),
                                          ("long", [8, 6, 7, 8], 60)])
def test_entries_past_the_old_bounds(case, n, steps):
    """40 and 72 seats (seat sets past a word: the actor mask's predicate
    over the wide rooms) and the 78-phase game's phase one-hot."""
    pair = {"werewolf-40": lambda: wide_pair(40), "werewolf-72": lambda: wide_pair(72),
            "long": long_pair}[case]()
    unroll_against_plain(pair.port, np.array(n), steps, seed=len(case))


@pytest.fixture(scope="module")
def spread_4097():
    """4097 werewolf rooms of mixed sizes after 200 scripted steps with
    auto-reset (K1's body built with g++), so that the rooms stand in the
    game's phases as a long run leaves them."""
    lw = lowered_game("werewolf").port
    rng = np.random.default_rng(41)
    B = 4097
    st = init_state(lw, B, torch.as_tensor(room_sizes(lw, B, rng), dtype=torch.int32),
                    np.arange(B, dtype=np.uint32) * 3 + 1, device="cpu")
    return lw, host_rollout(lw, st, 200)[0]


@pytest.mark.parametrize("rooms_per_block", [1, 3, 4, 8, 16])
def test_block_boundary_batches(spread_4097, rooms_per_block):
    """OB's block body bit for bit at batches around its block of R rooms
    (1, R - 1, R + 1 and 4097 rooms: a last block part full, a block's
    stretch of the observation starting and ending inside a 16-byte run),
    for the R that ob_plan gives werewolf on an H100 (8 at 4096 rooms, 16
    at 65,536; chip_smoke.py --profile prints it) and others, both views,
    with each mask alone."""
    lw, full = spread_4097
    R = rooms_per_block
    assert len(set(full.phase.tolist())) > 10
    for B in sorted({1, max(R - 1, 1), R + 1, 4097}):
        st = GameState(*(t[:B].contiguous() for t in full))
        for masked in (True, False):
            obs, legal, actor = host_observe(lw, st, masked, rooms_per_block=R)
            assert_bitwise(obs, N.observe_plain(lw, st, masked), f"B={B} obs masked={masked}")
            assert_bitwise(legal, N.legal_action_mask_plain(lw, st), f"B={B} legal")
            assert_bitwise(actor, P.actor_mask_plain(lw, st), f"B={B} actor")
        legal_only = host_observe(lw, st, obs=False, actor=False, rooms_per_block=R)
        assert legal_only[0] is None and legal_only[2] is None
        assert_bitwise(legal_only[1], N.legal_action_mask_plain(lw, st), f"B={B} legal alone")
        actor_only = host_observe(lw, st, obs=False, legal=False, rooms_per_block=R)[2]
        assert_bitwise(actor_only, P.actor_mask_plain(lw, st), f"B={B} actor alone")


def test_out_of_range_codes_and_seats_past_present():
    """String codes outside a field's vocabulary (negative and past it) give
    all-zero one-hots, a reveal flag makes role and team public, and seats
    past `present` are observed as the plain path observes them."""
    lw = lowered_game("werewolf").port
    rng = np.random.default_rng(3)
    st = init_state(lw, 6, torch.tensor([5, 6, 8, 4, 7, 8], dtype=torch.int32),
                    np.arange(6, dtype=np.uint32), device="cpu")
    for _ in range(4):
        st, _ = host_step(lw, st, host_bot_actions(lw, st))
    strs = torch.as_tensor(rng.integers(-128, 128, tuple(st.strs.shape)).astype(np.int8))
    nums = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, tuple(st.nums.shape),
                                        dtype=np.int64).astype(np.int32))
    bools = torch.as_tensor(rng.random(tuple(st.bools.shape)) < 0.5)
    odd = st._replace(strs=strs, nums=nums, bools=bools,
                      acted=torch.as_tensor(rng.random(tuple(st.acted.shape)) < 0.5))
    hold_observe(lw, odd, "odd banks")


def test_sample_matches_sample_actions_plain_on_the_same_uniforms():
    """host_sample fed the uniforms sample_actions_plain draws from the same
    generator seed, on a net's logits of real states: actions exact, logp
    within 1e-6; and with every logit and uniform of a row equal (ties
    broken to the first index, as torch.argmax)."""
    pair = lowered_game("werewolf")
    lw = pair.port
    cfg, jp = jax_params(pair.jax, "mlp", hidden=32)
    params, pcfg = port_params(jp), port_cfg(cfg)
    st = init_state(lw, 8, 6, np.arange(8, dtype=np.uint32) + 3, device="cpu")
    for t in range(12):
        obs = N.observe_plain(lw, st)
        a, logp, v, legal = N.sample_actions_plain(lw, params, st, pcfg, obs=obs,
                                                   generator=torch.Generator().manual_seed(t))
        logits, _ = N.apply_net(params, obs, pcfg, lw)
        u = torch.rand(logits.shape, generator=torch.Generator().manual_seed(t))
        ka, _, klogp = host_sample(logits, legal, u)
        assert torch.equal(ka, a) and float((klogp - logp).abs().max()) <= 1e-6
        flat = torch.zeros_like(logits)
        ta, _, tlogp = host_sample(flat, legal, torch.full_like(u, 0.5))
        ra, rlogp = N.draw_plain(flat, legal, torch.full_like(u, 0.5).log().neg().log().neg())
        assert torch.equal(ta, ra) and float((tlogp - rlogp).abs().max()) <= 1e-6
        st, _ = host_step(lw, st, torch.where(P.actor_mask_plain(lw, st), a, 0))
        st = host_reset_done(lw, st)


# choices a row on both sides of each lane-group width (1, 2, 4, 8, 16 and
# 32 lanes of 8 choices) and of a warp's passes of 256, multiples of 4
# (loads of 4) and not
SAMPLE_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 9, 16, 17, 31, 32, 33, 64, 65, 72, 73, 100, 128, 129,
                 256, 257, 300)


def lane_group_inputs(A: int, seed: int) -> tuple:
    """(logits, legal, uniforms, actor) over 37 rows of A choices from a
    numpy seed (37: no multiple of a warp's 2, 4, 8, 16 or 32 rows), with
    the edges forced: row 0 has no legal choice and a zero uniform; rows 1
    and 2 have every logit and uniform equal (all legal, then some); rows 3
    to 5 hold the same largest value at two indices: lanes apart, in one
    lane's choices, and in two passes."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((37, A)).astype(np.float32)
    legal = rng.random((37, A)) < 0.6
    u = rng.random((37, A)).astype(np.float32)
    legal[0] = False
    u[0, A // 2] = 0.0
    legal[1] = True
    logits[1:3] = 0.25
    u[1:3] = u[1:3, :1]
    for row, (i, j) in zip((3, 4, 5), ((A // 3, A - 1), (1, 3), (5, 261))):
        if i < j < A:
            legal[row, [i, j]] = True
            logits[row, [i, j]] = 50.0
            u[row, [i, j]] = 0.75
    actor = rng.random(37) < 0.5
    return (torch.as_tensor(logits), torch.as_tensor(legal), torch.as_tensor(u),
            torch.as_tensor(actor))


@pytest.mark.parametrize("A", SAMPLE_WIDTHS)
def test_sample_lane_groups(A):
    """The kernel's body at every lane-group width (host_sample runs a row's
    lanes through the kernel's butterflies) against the plain draw, in the
    three modes, with the actor mask and without: actions and actor-masked
    actions exact (ties to the first index), logp within 1e-6."""
    logits, legal, u, actor = lane_group_inputs(A, A)
    g = -torch.log(-torch.log(u.clamp_min(TINY)))
    ra, rlogp = N.draw_plain(logits, legal, g)
    for mode, noise in (("uniform", u), ("gumbel", g)):
        for who in (actor, None):
            a, acting, logp = host_sample(logits, legal, noise, who, mode=mode)
            assert_bitwise(a, ra, f"{mode} actions")
            if who is None:
                assert acting is None
            else:
                assert_bitwise(acting, torch.where(who, ra, 0), f"{mode} actor-masked")
            assert float((logp - rlogp).abs().max()) <= 1e-6, mode
    ga = first_argmax(torch.where(legal, logits, -1e9)).to(torch.int32) + 1
    for who in (actor, None):
        a, greedy, logp = host_sample(logits, legal, actor=who, mode="greedy")
        keep = legal.any(-1) if who is None else legal.any(-1) & who
        assert_bitwise(a, ga, "greedy actions")
        assert_bitwise(greedy, torch.where(keep, ga, 0), "greedy masked")
        assert logp is None
    assert int(ra[0]) >= 1 and int(greedy[0]) == 0  # no legal choice: the noise alone, no act
    if A % 4 == 0:  # inputs one element past an aligned start: read a choice at a time
        def shifted(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype)
            flat[1:] = t.reshape(-1)
            return flat[1:].view(t.shape)

        got = host_sample(shifted(logits), shifted(legal), shifted(u), actor)
        for x, y in zip(got, host_sample(logits, legal, u, actor)):
            assert_bitwise(x, y, "unaligned")
    for row, (i, j) in ((1, (0, 1)), (3, (A // 3, A - 1)), (4, (1, 3)), (5, (5, 261))):
        if i < j < A:
            assert int(ra[row]) == i + 1 and int(ga[row]) == i + 1, (row, A)


def test_sample_modes_and_edges():
    """Batches of (rooms, seats) rows with no legal choice (all logits at
    -1e9: the draw of the noise alone, logp -log(A)) and a zero uniform,
    against the plain draw and the greedy body, and the checks on bad
    input. The "gumbel" mode and the greedy mode without an actor mask at
    these widths are test_sample_lane_groups' cases."""
    rng = np.random.default_rng(11)
    for A in (1, 8, 73):
        legal = torch.as_tensor(rng.random((5, 4, A)) < 0.5)
        legal[0] = False
        logits = torch.as_tensor(rng.standard_normal((5, 4, A)).astype(np.float32))
        u = torch.as_tensor(rng.random((5, 4, A)).astype(np.float32))
        u[1, 1] = 0.0  # clamped to the least normal float
        actor = torch.as_tensor(rng.random((5, 4)) < 0.5)
        hold_sample(logits, legal, u, actor, torch.ones(5, 4, dtype=torch.bool), f"A={A}")
        assert float((host_sample(logits, legal, u)[2][0] + np.log(A)).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="legal must be"):
        host_sample(logits, legal[..., :1], u)
    with pytest.raises(ValueError, match="noise must be"):
        host_sample(logits, legal, u.double())
    with pytest.raises(ValueError, match="no noise"):
        host_sample(logits, legal, u, mode="greedy")
    with pytest.raises(ValueError, match="mode must be"):
        host_sample(logits, legal, u, mode="top_k")


@pytest.mark.parametrize("mode", ["uniform", "gumbel", "greedy"])
def test_sample_outputs_of_one_buffer(mode):
    """The wrapper's three outputs are rows of one buffer: each has the
    callers' shape and dtype, is contiguous, and writing one moves no
    other; the ones a mode does not return are None, as before."""
    rng = np.random.default_rng(5)
    for batch in ((3, 4), (7,), ()):
        logits = torch.as_tensor(rng.standard_normal(batch + (6,)).astype(np.float32))
        legal = torch.as_tensor(rng.random(batch + (6,)) < 0.7)
        noise = None if mode == "greedy" else torch.as_tensor(
            rng.random(batch + (6,)).astype(np.float32))
        actor = torch.ones(batch, dtype=torch.bool)
        a, masked, logp = host_sample(logits, legal, noise, actor, mode=mode)
        assert (logp is None) == (mode == "greedy")
        outs = [x for x in (a, masked, logp) if x is not None]
        for x, dtype in zip(outs, (torch.int32, torch.int32, torch.float32)):
            assert x.shape == batch and x.dtype == dtype and x.is_contiguous()
        before = [x.clone() for x in outs]
        for k, x in enumerate(outs):
            x.fill_(-7)
            for y, was in zip(outs[k + 1:], before[k + 1:]):
                assert torch.equal(y, was), (mode, batch, k)
        if mode != "greedy":
            assert host_sample(logits, legal, noise, mode=mode)[1] is None


@pytest.mark.parametrize("seats", [8, 72])
def test_sample_matches_jax_sample_actions_on_its_gumbel_noise(seats):
    """host_sample in the "gumbel" mode fed the Gumbel noise that
    jax.random.categorical draws from the key of the JAX package's
    sample_actions, on logits from a numpy seed (every third room's all
    equal) and the legal masks of JAX states along a scripted rollout:
    actions exact, logp within 1e-6 of JAX's."""
    pair = lowered_game("werewolf") if seats == 8 else wide_pair(seats)
    lw, jlw = pair.port, pair.jax
    A, B, rng = N.action_space(lw), 4, np.random.default_rng(seats)
    assert A == seats
    eng = JaxBatchedEngine(jlw)

    @jax.jit
    def draw(jst, key, logits):
        got = JN.sample_actions(jlw, None, jst, key, None, obs=jnp.zeros(()),
                                apply_fn=lambda p, o: (logits, logits[..., 0]))
        return got, jax.random.gumbel(key, logits.shape, jnp.float32)

    jst = jax_init_state(jlw, B, seats, rng.integers(0, 2 ** 32, B, dtype=np.uint64)
                         .astype(np.uint32))
    for t in range(4):
        logits = rng.standard_normal((B, seats, A)).astype(np.float32)
        logits[::3] = 0.5
        (ja, jlogp, _, jlegal), noise = draw(jst, jax.random.PRNGKey(t), jnp.asarray(logits))
        ja, jlegal, noise = np.array(ja), np.array(jlegal), np.array(noise)
        # the noise is the one categorical drew: its first argmax is JAX's draw
        np.testing.assert_array_equal(
            np.argmax(np.where(jlegal, logits, np.float32(-1e9)) + noise, -1) + 1, ja)
        a, _, logp = host_sample(torch.as_tensor(logits), torch.as_tensor(jlegal),
                                 torch.as_tensor(noise), mode="gumbel")
        np.testing.assert_array_equal(a.numpy(), ja)
        assert float(np.abs(logp.numpy() - np.asarray(jlogp)).max()) <= 1e-6, t
        jst = eng.step(jst, eng.bot_actions(jst))


@pytest.mark.parametrize("name", ["werewolf", "cult-of-the-depths", "bounty-arena"])
def test_plain_and_host_entries_match_jax(name):
    """The port's plain functions and the g++ entries against the JAX
    package's observe(...).astype(bf16) (both views), legal_action_mask,
    actor_mask and terminal_rewards (team and score modes), exact, on JAX
    states along a scripted rollout from a numpy seed, to episode ends."""
    pair = lowered_game(name)
    lw, jlw = pair.port, pair.jax
    B, rng = 6, np.random.default_rng(len(name))
    n = min(6, lw.P)
    eng = JaxBatchedEngine(jlw)
    j_obs = jax.jit(lambda s, masked: JN.observe(jlw, s, masked=masked).astype(jnp.bfloat16),
                    static_argnums=1)
    j_masks = jax.jit(lambda s: (JN.legal_action_mask(jlw, s), JP.actor_mask(jlw, s)))
    j_rewards = jax.jit(lambda s, e: JP.terminal_rewards(jlw, s, e))
    jst = jax_init_state(jlw, B, n, rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32))
    ended_any = False
    for t in range(96):
        st = host_state(jst)
        obs, legal, actor = host_observe(lw, st)
        full = host_observe(lw, st, masked=False)[0]
        assert_bitwise(obs, N.observe_plain(lw, st), f"t={t}")
        assert_bitwise(full, N.observe_plain(lw, st, False), f"t={t}")
        np.testing.assert_array_equal(obs.float().numpy(), to_np(j_obs(jst, True)), f"t={t}")
        np.testing.assert_array_equal(full.float().numpy(), to_np(j_obs(jst, False)))
        jlegal, jactor = j_masks(jst)
        np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
        np.testing.assert_array_equal(actor.numpy(), np.asarray(jactor))
        np.testing.assert_array_equal(P.actor_mask_plain(lw, st).numpy(), actor.numpy())
        nxt = eng.step(jst, eng.bot_actions(jst))
        ended = nxt.done & ~jst.done
        pnxt, pended = host_state(nxt), torch.as_tensor(np.array(ended))
        want_r = np.asarray(j_rewards(nxt, ended))
        np.testing.assert_array_equal(host_rewards(lw, pnxt, pended).numpy(), want_r)
        np.testing.assert_array_equal(P.terminal_rewards_plain(lw, pnxt, pended).numpy(), want_r)
        ended_any |= bool(np.asarray(ended).any())
        jst = jax.tree.map(lambda f, o: jnp.where(
            nxt.done.reshape((-1,) + (1,) * (o.ndim - 1)), f, o),
            jax_init_state(jlw, B, n, np.arange(B, dtype=np.uint32) + 1000 + t), nxt)
    assert ended_any


def test_routed_unroll_on_cpu_equals_the_plain_unroll():
    """make_unroll on CPU tensors (net.observe_all, sample_actions with the
    actor mask, terminal_rewards: their plain bodies here) takes the same
    trajectory as the loop of plain calls the unroll ran before OB and SA."""
    lw = lowered_game("werewolf").port
    cfg = P.PPOConfig(horizon=6, net=N.NetConfig(hidden=16, layers=1))
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw),
                           N.action_space(lw), cfg.net, lw, device="cpu")
    start = init_state(lw, 8, 6, np.arange(8, dtype=np.uint32), device="cpu")
    state, traj = P.make_unroll(lw, cfg)(params, start, torch.Generator().manual_seed(3))

    gen, st, step, steps = torch.Generator().manual_seed(3), start, make_step(lw), []
    with torch.no_grad():
        for _ in range(cfg.horizon):
            obs = N.observe_plain(lw, st)
            a, logp, v, legal = N.sample_actions_plain(lw, params, st, cfg.net, obs=obs,
                                                       generator=gen)
            mask = P.actor_mask_plain(lw, st)
            actions = torch.where(mask, a, 0)
            nxt = step(st, actions)
            ended = nxt.done & ~st.done
            reward = P.terminal_rewards_plain(lw, nxt, ended)
            st = E.reset_where_done(lw, nxt)
            steps.append(P.Rollout(obs, actions, logp, v, reward, ended, mask, legal))
    ref = P.Rollout(*(torch.stack(xs) for xs in zip(*steps)))
    assert all(torch.equal(x, y) for x, y in zip(state, st))
    for name, x, y in zip(P.Rollout._fields, traj, ref):
        assert torch.equal(x, y), name


def test_host_entries_unroll_equals_the_plain_unroll():
    """The unroll step as the card runs it (OB, the forward, SA with the
    actor mask, ST, OB's rewards, ST's reset), through the g++ entries on
    the CPU, against the plain unroll on the same uniforms: every field
    bit for bit, logp within 1e-6."""
    lw = lowered_game("werewolf").port
    cfg = N.NetConfig(hidden=16, layers=1)
    params = N.init_params(torch.Generator().manual_seed(1), N.obs_dim(lw),
                           N.action_space(lw), cfg, lw, device="cpu")
    st = init_state(lw, 8, 6, np.arange(8, dtype=np.uint32) + 40, device="cpu")
    ref = st
    for t in range(40):
        obs, legal, actor = host_observe(lw, st)
        logits, _ = N.apply_net(params, obs, cfg, lw)
        u = torch.rand(logits.shape, generator=torch.Generator().manual_seed(t))
        _, actions, logp = host_sample(logits, legal, u, actor)
        nxt, ended = host_step(lw, st, actions)
        reward = host_rewards(lw, nxt, ended)
        st = host_reset_done(lw, nxt)

        robs = N.observe_plain(lw, ref)
        ra, rlogp, _, rlegal = N.sample_actions_plain(
            lw, params, ref, cfg, obs=robs, generator=torch.Generator().manual_seed(t))
        rmask = P.actor_mask_plain(lw, ref)
        rnxt = make_step(lw)(ref, torch.where(rmask, ra, 0))
        rended = rnxt.done & ~ref.done
        rreward = P.terminal_rewards_plain(lw, rnxt, rended)
        ref = E.reset_where_done(lw, rnxt)
        for got, want, what in ((obs, robs, "obs"), (legal, rlegal, "legal"),
                                (actor, rmask, "actor"), (actions, torch.where(rmask, ra, 0),
                                                          "actions"),
                                (ended, rended, "ended"), (reward, rreward, "reward")):
            assert_bitwise(got, want, f"{what} t={t}")
        assert float((logp - rlogp).abs().max()) <= 1e-6
        assert all(torch.equal(x, y) for x, y in zip(st, ref)), f"state t={t}"


def test_routed_calls_keep_the_cpu_path():
    """observe, observe_all, legal_action_mask, sample_actions, actor_mask
    and terminal_rewards on CPU tensors are the plain bodies;
    PolicyBots.greedy too."""
    lw = lowered_game("werewolf").port
    st = init_state(lw, 4, 6, np.arange(4, dtype=np.uint32), device="cpu")
    st, ended = host_step(lw, st, host_bot_actions(lw, st))
    assert torch.equal(N.observe(lw, st), N.observe_plain(lw, st))
    assert torch.equal(N.observe(lw, st, masked=False), N.observe_plain(lw, st, False))
    assert torch.equal(N.legal_action_mask(lw, st), N.legal_action_mask_plain(lw, st))
    assert torch.equal(P.actor_mask(lw, st), P.actor_mask_plain(lw, st))
    assert torch.equal(P.terminal_rewards(lw, st, ended), P.terminal_rewards_plain(lw, st, ended))
    obs, legal, actor = N.observe_all(lw, st)
    assert torch.equal(obs, N.observe_plain(lw, st)) and torch.equal(
        legal, N.legal_action_mask_plain(lw, st)) and torch.equal(actor, P.actor_mask_plain(lw, st))
    assert N.observe_all(lw, st, actor=False)[2] is None
    cfg = N.NetConfig(hidden=16, layers=1)
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw), N.action_space(lw),
                           cfg, lw, device="cpu")
    a, logp, _, _ = N.sample_actions(lw, params, st, cfg, actor=actor,
                                     generator=torch.Generator().manual_seed(1))
    ra, rlogp, _, _ = N.sample_actions_plain(lw, params, st, cfg,
                                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, torch.where(actor, ra, 0)) and torch.equal(logp, rlogp)


def test_wrapper_checks_raise():
    """No silent CPU fallback and no launch on bad input: the CUDA wrappers
    refuse CPU tensors, the host entries a wrong dtype or shape."""
    lw = lowered_game("werewolf").port
    st = init_state(lw, 2, 6, 0, device="cpu")
    legal = N.legal_action_mask_plain(lw, st)
    logits = torch.zeros(legal.shape)
    for call in (lambda: kernel_observe(lw, st), lambda: kernel_rewards(lw, st, st.done),
                 lambda: kernel_sample(logits, legal, torch.rand(legal.shape))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="field nums"):
        host_observe(lw, st._replace(nums=st.nums.to(torch.int64)))
    with pytest.raises(ValueError, match="ended must be"):
        host_rewards(lw, st, st.done.to(torch.int32))
    with pytest.raises(ValueError):
        host_observe(builtin_pair("potlatch").port, st)
    meta = GameState(*(torch.empty_like(t, device="meta") for t in st))
    with pytest.raises(ValueError, match="CPU tensors"):
        host_observe(lw, meta)
