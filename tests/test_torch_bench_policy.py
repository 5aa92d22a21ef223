"""The port's learned-policy self-play loop (bench.py --policy,
game_engine_tpu_torch.bench.policy_steps) against a JAX scan built from the
modules the root bench.py's policy_rollout_bench uses (observe + apply_net
inside sample_actions, actor_mask, make_step, init_state_like): werewolf, 8
rooms of 8 seats x 6 steps, the mlp at hidden 32. The port is fed JAX's
parameters and JAX's own Gumbel draws (jax.random.categorical(key, l) ==
argmax(l + gumbel(key, l.shape))), so the final GameState must be equal
field by field and the episode count the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from game_engine_tpu.core.engine import init_state_like
from game_engine_tpu.core.state import init_state as j_init_state
from game_engine_tpu.core.step import make_step
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train.ppo import actor_mask
from game_engine_tpu_torch.bench import POLICY_SEED, policy_steps
from game_engine_tpu_torch.core.state import init_state
from tests.test_torch_net import one_torch_thread, port_cfg, port_params, to_np  # noqa: F401
from tests.test_torch_state import assert_same_state, builtin_pair

B, STEPS, HIDDEN = 8, 6, 32


def jax_loop(lw, params, cfg, state, key):
    """policy_rollout_bench's scan body over STEPS steps -> (state, episodes,
    the Gumbel noise each step's categorical drew)."""
    step = make_step(lw)

    def body(carry, _):
        st, k = carry
        k, sk = jax.random.split(k)
        a, _, _, mask = JN.sample_actions(lw, params, st, sk, cfg)
        noise = jax.random.gumbel(sk, mask.shape)
        actions = jnp.where(actor_mask(lw, st), a, 0)
        nxt = step(st, actions)
        eps = jnp.sum((nxt.done & ~st.done).astype(jnp.int32))
        fresh = init_state_like(lw, nxt)
        nxt = jax.tree_util.tree_map(
            lambda new, old: jnp.where(nxt.done.reshape((-1,) + (1,) * (old.ndim - 1)), new, old),
            fresh, nxt)
        return (nxt, k), (eps, noise)

    (state, _), (eps, noise) = jax.lax.scan(body, (state, key), None, length=STEPS)
    return state, jnp.sum(eps), noise


def test_policy_loop_matches_jax_scan():
    pair = builtin_pair("werewolf")
    jcfg = JN.NetConfig(hidden=HIDDEN, layers=2)
    assert jcfg.arch == "mlp"
    jp = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(pair.jax), JN.action_space(pair.jax),
                        jcfg)
    seeds = np.arange(B, dtype=np.uint32)
    j_end, j_eps, noise = jax.jit(lambda s, k: jax_loop(pair.jax, jp, jcfg, s, k))(
        j_init_state(pair.jax, B, 8, seeds), jax.random.PRNGKey(POLICY_SEED))
    gumbel = [torch.from_numpy(to_np(noise[t]).copy()) for t in range(STEPS)]
    start = init_state(pair.port, B, 8, seeds, device="cpu")
    end, eps = policy_steps(pair.port, port_params(jp), port_cfg(jcfg), start, STEPS,
                            gumbel=gumbel)
    assert_same_state(j_end, end)
    assert int(eps) == int(j_eps)
    assert not torch.equal(end.phase, start.phase)  # the rooms moved
