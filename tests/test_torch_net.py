"""The PyTorch port's policy net (game_engine_tpu_torch/policies/net.py)
against the JAX package's: observations and legal-action masks exact on
states from a JAX scripted rollout, apply_net close (2e-2 of the max
|logit|) for mlp, deepsets and attn, sampled actions exact given JAX's own
Gumbel noise, and the shipped checkpoint loading with numpy alone."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.policies import net as JN
from game_engine_tpu_torch.core.state import state_from_numpy
from game_engine_tpu_torch.policies import net as N
from tests.test_torch_state import builtin_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "checkpoints", "attn_werewolf_u120.npz")
ARCHS = ("mlp", "deepsets", "attn")


def lowered_game(name):
    """The JAX package's and the port's Lowered of a catalog game."""
    return builtin_pair(name)


def host_state(jst):
    """A JAX GameState as the port's, on the CPU."""
    return state_from_numpy(jst, device="cpu")


def jax_states(lw, B=6, n=6, steps=40, every=5, seed=11):
    """JAX GameStates along a scripted rollout (every `every` steps)."""
    eng = JaxBatchedEngine(lw)
    st = jax_init_state(lw, B, n, np.arange(B, dtype=np.uint32) + seed)
    out = [st]
    for t in range(1, steps + 1):
        st = eng.step(st, eng.bot_actions(st))
        if t % every == 0:
            out.append(st)
    return out


def to_np(x):
    """A JAX array (bf16 included) as f32/int numpy."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def jax_params(lw, arch, hidden=64, seed=0):
    cfg = JN.NetConfig(hidden=hidden, arch=arch)
    p = JN.init_params(jax.random.PRNGKey(seed), JN.obs_dim(lw), JN.action_space(lw), cfg, lw)
    # non-trivial biases and LayerNorm affine, so their paths are exercised
    rng = np.random.default_rng(seed)
    p = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             if k.startswith(("b", "ln")) else v) for k, v in p.items()}
    return cfg, p


def port_params(p):
    return N.params_from_numpy({k: np.asarray(v) for k, v in p.items()}, device="cpu")


def port_cfg(cfg):
    return N.NetConfig(hidden=cfg.hidden, layers=cfg.layers, arch=cfg.arch,
                       attn_heads=cfg.attn_heads)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors. The test workers share
    the cores, and torch's default of a thread per core oversubscribes
    them: six concurrent CPU train runs took 552 s each instead of 12 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ww_pair():
    return lowered_game("werewolf")


@pytest.fixture(scope="module")
def ww(ww_pair):
    """werewolf lowered by the JAX package, for the JAX functions."""
    return ww_pair.jax


@pytest.fixture(scope="module")
def pww(ww_pair):
    """werewolf lowered by the port, for the port's functions."""
    return ww_pair.port


@pytest.fixture(scope="module")
def ww_states(ww):
    return jax_states(ww)


@pytest.mark.parametrize("masked", [True, False])
def test_observe_exact(ww, pww, ww_states, masked):
    for jst in ww_states:
        want = to_np(JN.observe(ww, jst, masked=masked))
        got = N.observe(pww, host_state(jst), masked=masked)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("game", ["two-truths-and-a-lie", "cult-of-the-depths", "gold-rush", "masquerade-gala"])
def test_observe_and_legal_mask_exact_other_games(game):
    pair = lowered_game(game)
    lw = pair.jax
    n = min(lw.P, 6)
    for jst in jax_states(lw, B=4, n=n, steps=20, every=10, seed=5):
        st = host_state(jst)
        np.testing.assert_array_equal(N.observe(pair.port, st).float().numpy(),
                                      to_np(JN.observe(lw, jst)))
        np.testing.assert_array_equal(N.legal_action_mask(pair.port, st).numpy(),
                                      np.asarray(JN.legal_action_mask(lw, jst)))


def test_dims_match_jax(ww, pww):
    assert N.obs_dim(pww) == JN.obs_dim(ww)
    assert N.action_space(pww) == JN.action_space(ww)
    assert N._per_player_dim(pww) == JN._per_player_dim(ww)
    assert N.field_visibility(pww) == JN.field_visibility(ww)
    np.testing.assert_array_equal(N._phase_public_acting(pww), JN._phase_public_acting(ww))
    assert N.minority_team_code(pww) == JN.minority_team_code(ww)


def test_legal_action_mask_exact(ww, pww, ww_states):
    for jst in ww_states:
        np.testing.assert_array_equal(
            N.legal_action_mask(pww, host_state(jst)).numpy(),
            np.asarray(JN.legal_action_mask(ww, jst)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_jax(ww, pww, arch):
    cfg, jp = jax_params(ww, arch)
    tp = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(pww), N.action_space(pww),
                       port_cfg(cfg), pww, device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert tp[k].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_net_close_to_jax(ww, pww, ww_states, arch):
    cfg, jp = jax_params(ww, arch)
    tp = port_params(jp)
    for jst in ww_states[::2]:
        obs = JN.observe(ww, jst)
        l0, v0 = JN.apply_net(jp, obs, cfg, ww)
        l1, v1 = N.apply_net(tp, torch.as_tensor(to_np(obs)).bfloat16(), port_cfg(cfg), pww)
        assert tuple(l1.shape) == l0.shape and tuple(v1.shape) == v0.shape
        assert rel_err(l1.numpy(), to_np(l0)) < 2e-2
        assert rel_err(v1.numpy(), to_np(v0)) < 2e-2


def test_sample_actions_exact_given_jax_gumbel(ww, pww, ww_states):
    """jax.random.categorical(key, l) == argmax(l + gumbel(key, l.shape)):
    feeding JAX's noise gives JAX's actions wherever the top two perturbed
    logits are more than 1e-3 apart."""
    cfg, jp = jax_params(ww, "attn")
    tp = port_params(jp)
    checked = 0
    for i, jst in enumerate(ww_states):
        key = jax.random.PRNGKey(100 + i)
        ja, jlogp, jv, jmask = JN.sample_actions(ww, jp, jst, key, cfg)
        logits, _ = JN.apply_net(jp, JN.observe(ww, jst), cfg, ww)
        logits = jnp.where(jmask, logits, -1e9)
        noise = jax.random.gumbel(key, logits.shape)
        pert = np.sort(to_np(logits + noise), axis=-1)
        clear = (pert[..., -1] - pert[..., -2]) > 1e-3
        a, logp, v, mask = N.sample_actions(pww, tp, host_state(jst), port_cfg(cfg),
                                            gumbel=torch.as_tensor(to_np(noise)))
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(a.numpy()[clear], np.asarray(ja)[clear])
        ok = np.asarray(ja) == a.numpy()
        assert np.abs(logp.numpy()[ok] - to_np(jlogp)[ok]).max() < 2e-2
        assert rel_err(v.numpy(), to_np(jv)) < 2e-2
        checked += int(clear.sum())
    assert checked > 100


def test_sample_actions_from_generator(ww, pww, ww_states):
    cfg, jp = jax_params(ww, "deepsets")
    st = host_state(ww_states[3])
    a1 = N.sample_actions(pww, port_params(jp), st, port_cfg(cfg),
                          generator=torch.Generator().manual_seed(4))[0]
    a2 = N.sample_actions(pww, port_params(jp), st, port_cfg(cfg),
                          generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a1, a2)
    legal = N.legal_action_mask(pww, st)
    assert bool(legal.gather(-1, (a1.long() - 1)[..., None]).all())
    with pytest.raises(ValueError):
        N.sample_actions(pww, port_params(jp), st, port_cfg(cfg))


def test_load_policy_matches_jax_apply_net(ww, pww, ww_states):
    """The shipped attn checkpoint through the port's numpy-only loader vs
    JAX apply_net on utils.checkpoint.load_tree's params, at full width."""
    from game_engine_tpu.utils.checkpoint import load_tree

    params, cfg = N.load_policy(CKPT, device="cpu")
    assert cfg == N.NetConfig(hidden=256, layers=2, arch="attn", attn_heads=1)
    assert len(params) == 17 and tuple(params["w0"].shape) == (275, 256)
    assert tuple(params["w_phi0"].shape) == (17, 128)
    jcfg = JN.NetConfig(hidden=256, arch="attn")
    like = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww), jcfg, ww)
    jp = load_tree(CKPT, like)
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jp[k]))
    for jst in ww_states[::3]:
        obs = JN.observe(ww, jst)
        l0, v0 = JN.apply_net(jp, obs, jcfg, ww)
        l1, v1 = N.apply_net(params, torch.as_tensor(to_np(obs)).bfloat16(), cfg, pww)
        assert rel_err(l1.numpy(), to_np(l0)) < 2e-2
        assert rel_err(v1.numpy(), to_np(v0)) < 2e-2


def test_save_policy_reads_back_in_both_packages(ww, tmp_path):
    from game_engine_tpu.policies.serve import load_policy as jax_load_policy

    cfg, jp = jax_params(ww, "attn")
    tp = port_params(jp)
    path = str(tmp_path / "ckpt_u1")
    N.save_policy(path, tp, meta={"attn_heads": 1})
    back, bcfg = N.load_policy(path + ".npz", device="cpu")
    jback, jcfg = jax_load_policy(path + ".npz")
    assert bcfg == port_cfg(cfg) and jcfg == cfg
    for k in tp:
        assert torch.equal(back[k], tp[k])
        np.testing.assert_array_equal(np.asarray(jback[k]), tp[k].numpy())


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import game_engine_tpu_torch.policies.net, game_engine_tpu_torch.policies.fused\n"
            "import game_engine_tpu_torch.train.ppo, game_engine_tpu_torch.train.run\n"
            "import game_engine_tpu_torch._build, game_engine_tpu_torch.core.engine\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
