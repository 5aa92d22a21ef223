"""The policy-net kernels' host side (game_engine_tpu_torch/policies/fused.py)
against the JAX package's Pallas kernels K2-K4 in interpret mode, on
observations of a werewolf scripted rollout at hidden 64:

  fused_forward_plain (K2's plain version)  vs FZ.make_apply forward, 2e-2
  autograd through it (K3's)                vs jax.vjp through FZ.make_apply, 5e-2
  make_loss_vg on CPU (K4's)                vs FZ.make_loss_vg and
                                               jax.value_and_grad(ppo_loss):
                                               loss 2e-2, metrics 5e-2 abs,
                                               grads 5e-2

Tolerances are those of tests/test_fused_net.py, relative to the max |ref|:
bf16 rounding points differ between XLA, the Pallas kernels and torch.
The CUDA kernels' own code, built with g++ into a host harness, is held
against the plain versions: the pipelines of K2, K3 and K4
(csrc/lossgrad.cuh, the stages, buffer layouts, chunks and slab order of
the tensor-core versions, with plain-loop products) over ragged chunks and
several row splits, within 5e-3 (forward) and 1e-3 (gradients) at hidden
64, and at the test_fused_net.py tolerances at widths whose storage is
padded (hidden 48: the trunk; 96 and 160: the encoder too), at 9 trunk
layers, and past what they held in registers or tables before (40 and 72
seats, 72 actions, 33 layers), where they are also held against the JAX
kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.policies import fused as JFZ
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch import _build
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N
from tests.test_torch_net import jax_params, jax_states, port_cfg, port_params, rel_err, to_np
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

CLIP, VF, ENT = 0.2, 0.5, 0.01


@pytest.fixture(scope="module")
def ww_pair():
    return builtin_pair("werewolf")


@pytest.fixture(scope="module")
def ww(ww_pair):
    """werewolf lowered by the JAX package, for the JAX functions."""
    return ww_pair.jax


@pytest.fixture(scope="module")
def pww(ww_pair):
    """werewolf lowered by the port, for the port's functions."""
    return ww_pair.port


def make_traj(ww):
    """A (T=3, B=6, P) slice of a JAX scripted rollout with PPO inputs made
    from a seeded numpy generator: legal masks and actor masks from the JAX
    package, actions drawn among the legal ones, noise for logp_old (see
    logp_old), advantages, returns and the dl/dv cotangents."""
    states = jax_states(ww, B=6, n=6, steps=30, every=10, seed=3)[1:]
    rng = np.random.default_rng(7)
    obs = np.stack([to_np(JN.observe(ww, s)) for s in states])          # (T, B, P, F)
    legal = np.stack([np.asarray(JN.legal_action_mask(ww, s)) for s in states])
    mask = np.stack([np.asarray(JP.actor_mask(ww, s)) for s in states])
    T, B, P, A = legal.shape
    u = rng.random((T, B, P, A)) * legal
    actions = (u.argmax(-1) + 1).astype(np.int32)
    return {"obs": obs, "legal": legal, "mask": mask, "actions": actions,
            "logp_noise": rng.normal(0.0, 0.3, (T, B, P)).astype(np.float32),
            "adv": rng.normal(size=(T, B, P)).astype(np.float32),
            "ret": rng.normal(size=(T, B, P)).astype(np.float32),
            "dl": rng.normal(size=(T * B * P, A)).astype(np.float32),
            "dv": rng.normal(size=(T * B * P,)).astype(np.float32)}


@pytest.fixture(scope="module")
def traj(ww):
    return make_traj(ww)


def rows_of(traj, d):
    return torch.as_tensor(traj["obs"].reshape(-1, d.F)).bfloat16().contiguous()


def grads_close(got: dict, want: dict, tol=5e-2):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        assert rel_err(g, w) < tol, (k, rel_err(g, w))


def plain_vjp(d, rows, params, dl, dv):
    leaves = {k: params[k].clone().requires_grad_(True) for k in FZ._param_names(d)}
    lo, vo = FZ.fused_forward_plain(d, rows, leaves)
    g = torch.autograd.grad((lo * dl).sum() + (vo * dv).sum(), list(leaves.values()))
    return dict(zip(leaves, g))


def logp_old(traj, jp, jcfg, ww):
    """The policy's log-prob of each taken action, plus seeded noise."""
    logits, _ = JN.apply_net(jp, jnp.asarray(traj["obs"], jnp.bfloat16), jcfg, ww)
    logits = jnp.where(traj["legal"], logits, -1e9)
    lp = jax.nn.log_softmax(logits, -1)
    lp = np.take_along_axis(np.asarray(lp), traj["actions"][..., None] - 1, -1)[..., 0]
    return (lp + traj["logp_noise"]).astype(np.float32)


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
def test_forward_plain_matches_jax_kernel(ww, pww, traj, arch):
    jcfg, jp = jax_params(ww, arch)
    cfg = port_cfg(jcfg)
    d = FZ.dims_for(pww, cfg)
    assert d.F == JFZ.dims_for(ww, jcfg).F and d.A == JFZ.dims_for(ww, jcfg).A
    l0, v0 = JFZ.make_apply(ww, jcfg)(jp, jnp.asarray(traj["obs"], jnp.bfloat16))
    params = port_params(jp)
    l1, v1 = FZ.fused_forward_plain(d, rows_of(traj, d), params)
    assert rel_err(l1.numpy(), to_np(l0).reshape(-1, d.A)) < 2e-2
    assert rel_err(v1.numpy(), to_np(v0).reshape(-1)) < 2e-2
    # the tensor-core K2's own stages (host pipeline) against the JAX kernel
    l3, v3 = FZ.host_forward(d, rows_of(traj, d), params, chunk_rows=40)
    assert rel_err(l3.numpy(), to_np(l0).reshape(-1, d.A)) < 2e-2
    assert rel_err(v3.numpy(), to_np(v0).reshape(-1)) < 2e-2
    # make_apply on CPU tensors takes the plain version, any leading dims
    l2, v2 = FZ.make_apply(pww, cfg)(params, torch.as_tensor(traj["obs"]).bfloat16())
    assert tuple(l2.shape) == l0.shape and tuple(v2.shape) == v0.shape
    assert torch.equal(l2.reshape(-1, d.A), l1) and torch.equal(v2.reshape(-1), v1)


def test_backward_plain_matches_jax_kernel(ww, pww, traj):
    """K3's plain version (autograd through fused_forward_plain) against
    the custom VJP of the Pallas pair, for seeded dl/dv cotangents."""
    jcfg, jp = jax_params(ww, "attn")
    d = FZ.dims_for(pww, port_cfg(jcfg))
    obs = jnp.asarray(traj["obs"], jnp.bfloat16)
    apply = JFZ.make_apply(ww, jcfg)
    lead = obs.shape[:-1]
    _, vjp = jax.vjp(lambda p: apply(p, obs), jp)
    (want,) = vjp((jnp.asarray(traj["dl"]).reshape(lead + (d.A,)),
                   jnp.asarray(traj["dv"]).reshape(lead)))
    dl, dv = torch.as_tensor(traj["dl"]), torch.as_tensor(traj["dv"])
    got = plain_vjp(d, rows_of(traj, d), port_params(jp), dl, dv)
    grads_close(got, {k: np.asarray(v) for k, v in want.items()})
    # the tensor-core K3's own stages (host pipeline) against the JAX kernel
    piped = FZ.host_grads(d, rows_of(traj, d), torch.cat([dl, dv[:, None]], 1), port_params(jp),
                          chunk_rows=40, nsplit=3)
    grads_close({k: v.numpy() for k, v in piped.items()},
                {k: np.asarray(v) for k, v in want.items()})


def test_loss_vg_plain_matches_jax(ww, pww, traj):
    """K4's plain version against the one-pass Pallas loss-grad and
    jax.value_and_grad(ppo_loss) on the same trajectory, at the freshly
    initialised params test_fused_net.py uses. (With perturbed biases the
    XLA path, which carries the pointer head's cotangent in bf16, departs
    from the JAX package's own kernel by 5.4% on w_ptr.)"""
    jcfg = JN.NetConfig(hidden=64, arch="attn")
    jp = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww), jcfg, ww)
    cfg = port_cfg(jcfg)
    lp_old = logp_old(traj, jp, jcfg, ww)
    j_in = (jnp.asarray(traj["obs"], jnp.bfloat16), jnp.asarray(traj["legal"]),
            jnp.asarray(traj["actions"]), jnp.asarray(lp_old), jnp.asarray(traj["adv"]),
            jnp.asarray(traj["ret"]), jnp.asarray(traj["mask"]))
    (l_k, m_k), g_k = JFZ.make_loss_vg(ww, jcfg, CLIP, VF, ENT)(jp, *j_in)
    jcfg_ppo = JP.PPOConfig(clip=CLIP, vf_coef=VF, ent_coef=ENT, net=jcfg)
    jtraj = JP.Rollout(obs=j_in[0], actions=j_in[2], logp=j_in[3], value=None,
                       reward=None, done=None, mask=j_in[6], legal=j_in[1])
    (l_x, m_x), g_x = jax.value_and_grad(
        lambda p: JP.ppo_loss(p, jtraj, j_in[4], j_in[5], jcfg_ppo, ww), has_aux=True)(jp)

    t_in = (torch.as_tensor(traj["obs"]).bfloat16(), torch.as_tensor(traj["legal"]),
            torch.as_tensor(traj["actions"]), torch.as_tensor(lp_old),
            torch.as_tensor(traj["adv"]), torch.as_tensor(traj["ret"]),
            torch.as_tensor(traj["mask"]))
    (loss, metrics), grads = FZ.make_loss_vg(pww, cfg, CLIP, VF, ENT)(port_params(jp), *t_in)
    ratios = np.exp(-traj["logp_noise"])  # at the current params
    assert (ratios > 1 + CLIP).any() and (ratios < 1 - CLIP).any()
    for l_ref, m_ref, g_ref in ((l_k, m_k, g_k), (l_x, m_x, g_x)):
        assert abs(float(loss) - float(l_ref)) / (abs(float(l_ref)) + 1e-6) < 2e-2
        for k in ("pg_loss", "v_loss", "entropy", "ratio_mean"):
            assert abs(float(metrics[k]) - float(m_ref[k])) < 5e-2, k
        grads_close(grads, {k: np.asarray(v) for k, v in g_ref.items()})


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
def test_kernel_tile_code_matches_plain(ww, pww, traj, arch):
    """The kernels' code built with g++: K2's pipeline over chunks of 1 and
    5 rows and K3's over chunks of 2 rows and three row splits at hidden
    48 (the trunk's storage padded from 48 to 64 columns), and K4's over
    ragged chunks and three row splits (hidden 64), against the plain
    versions."""
    jcfg, jp = jax_params(ww, arch, hidden=48)
    d = FZ.dims_for(pww, port_cfg(jcfg))
    assert d.hidden % 32 and FZ.supports(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    assert len(FZ._meta(d)) == _build.lossgrad_host_lib().lg_meta_ints()
    l0, v0 = FZ.fused_forward_plain(d, rows, params)
    for chunk in (1, 5):
        l1, v1 = FZ.host_forward(d, rows, params, chunk_rows=chunk)
        assert rel_err(l1.numpy(), l0.numpy()) < 2e-2
        assert rel_err(v1.numpy(), v0.numpy()) < 2e-2

    dl, dv = torch.as_tensor(traj["dl"]), torch.as_tensor(traj["dv"])
    want = plain_vjp(d, rows, params, dl, dv)
    got = FZ.host_grads(d, rows, torch.cat([dl, dv[:, None]], 1), params, chunk_rows=2,
                        nsplit=3)
    grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()})

    jcfg, jp = jax_params(ww, arch)
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    rowin = FZ._loss_rows(d, torch.as_tensor(traj["legal"]), torch.as_tensor(traj["actions"]),
                          torch.as_tensor(traj["logp_noise"]) - 2.0,
                          torch.as_tensor(traj["adv"]), torch.as_tensor(traj["ret"]),
                          torch.as_tensor(traj["mask"]), VF)
    g_ref, s_ref = FZ.loss_vg_plain(d, rows, rowin, params, CLIP, ENT)
    g_k, s_k = FZ.host_loss_grads(d, rows, rowin, params, CLIP, ENT, chunk_rows=50, nsplit=3)
    grads_close({k: v.numpy() for k, v in g_k.items()}, {k: v.numpy() for k, v in g_ref.items()})
    np.testing.assert_allclose(s_k.numpy(), s_ref.numpy(), rtol=0, atol=5e-2)
    # the slab sums are in a fixed order: the same chunking gives the same bits
    g_again, _ = FZ.host_loss_grads(d, rows, rowin, params, CLIP, ENT, chunk_rows=50,
                                    nsplit=3)
    assert all(torch.equal(g_k[k], g_again[k]) for k in g_k)


# widths whose storage the pipelines pad (hidden 48: the trunk to 64; 96:
# hp 48 to 64 and the trunk; 160: hp 80 to 96 and the trunk to 192), and a
# trunk deeper than the earlier bound of 8 layers
PADDED = [(48, 2), (96, 2), (160, 2), (64, 9)]


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
@pytest.mark.parametrize("hidden,layers", PADDED)
def test_padded_pipelines_match_jax_kernels(ww, pww, traj, arch, hidden, layers):
    check_against_jax_kernels(ww, pww, traj, arch, hidden, layers)


def check_against_jax_kernels(ww, pww, traj, arch, hidden, layers):
    """K2, K3 and K4's pipelines (host_forward, host_grads, host_loss_grads)
    against the JAX package's Pallas kernels in interpret mode: make_apply's
    forward, its custom VJP for seeded dl/dv, and make_loss_vg at logp_old
    = the policy's own log-probs + noise, at the test_fused_net.py
    tolerances."""
    jcfg = JN.NetConfig(hidden=hidden, layers=layers, arch=arch)
    jp = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww), jcfg, ww)
    rng = np.random.default_rng(0)  # non-trivial biases and LayerNorm affine
    jp = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if k.startswith(("b", "ln")) else v) for k, v in jp.items()}
    d = FZ.dims_for(pww, port_cfg(jcfg))
    assert FZ.supports(pww, port_cfg(jcfg))
    obs = jnp.asarray(traj["obs"], jnp.bfloat16)
    lead = obs.shape[:-1]
    apply = JFZ.make_apply(ww, jcfg)
    rows, params = rows_of(traj, d), port_params(jp)
    rowin = torch.cat([torch.as_tensor(traj["dl"]), torch.as_tensor(traj["dv"])[:, None]], 1)
    (l0, v0), vjp = jax.vjp(lambda p: apply(p, obs), jp)
    (want,) = vjp((jnp.asarray(traj["dl"]).reshape(lead + (d.A,)),
                   jnp.asarray(traj["dv"]).reshape(lead)))
    want = {k: np.asarray(v) for k, v in want.items()}
    lp_old = logp_old(traj, jp, jcfg, ww)
    l1, v1 = FZ.host_forward(d, rows, params, chunk_rows=40)
    assert rel_err(l1.numpy(), to_np(l0).reshape(-1, d.A)) < 2e-2
    assert rel_err(v1.numpy(), to_np(v0).reshape(-1)) < 2e-2
    got = FZ.host_grads(d, rows, rowin, params, chunk_rows=40, nsplit=3)
    grads_close({k: v.numpy() for k, v in got.items()}, want)

    j_in = (obs, jnp.asarray(traj["legal"]), jnp.asarray(traj["actions"]), jnp.asarray(lp_old),
            jnp.asarray(traj["adv"]), jnp.asarray(traj["ret"]), jnp.asarray(traj["mask"]))
    (l_k, m_k), g_k = JFZ.make_loss_vg(ww, jcfg, CLIP, VF, ENT)(jp, *j_in)
    rowin = FZ._loss_rows(d, torch.as_tensor(traj["legal"]), torch.as_tensor(traj["actions"]),
                          torch.as_tensor(lp_old), torch.as_tensor(traj["adv"]),
                          torch.as_tensor(traj["ret"]), torch.as_tensor(traj["mask"]), VF)
    grads, stats = FZ.host_loss_grads(d, rows, rowin, params, CLIP, ENT, chunk_rows=50, nsplit=3)
    pg, v_loss, ent, ratio = (float(x) for x in stats)
    loss = pg + v_loss - ENT * ent
    assert abs(loss - float(l_k)) / (abs(float(l_k)) + 1e-6) < 2e-2
    for k, got_m in (("pg_loss", pg), ("v_loss", v_loss / VF), ("entropy", ent),
                     ("ratio_mean", ratio)):
        assert abs(got_m - float(m_k[k])) < 5e-2, k
    grads_close(grads, {k: np.asarray(v) for k, v in g_k.items()})


def test_loss_rows_pre_kernel_steps(ww, pww, traj):
    """rowin = legal | one-hot action | logp_old, normalised advantage,
    ret, mask / msum, vf / n, as fused.py:646-676 computes them."""
    d = FZ.dims_for(pww, N.NetConfig(hidden=64, arch="attn"))
    n, A = traj["mask"].size, d.A
    rowin = FZ._loss_rows(d, torch.as_tensor(traj["legal"]), torch.as_tensor(traj["actions"]),
                          torch.as_tensor(traj["logp_noise"]), torch.as_tensor(traj["adv"]),
                          torch.as_tensor(traj["ret"]), torch.as_tensor(traj["mask"]), VF)
    assert tuple(rowin.shape) == (n, 2 * A + 5) and rowin.dtype == torch.float32
    m = traj["mask"].reshape(n).astype(np.float64)
    adv = traj["adv"].reshape(n).astype(np.float64)
    mean = (adv * m).sum() / m.sum()
    std = np.sqrt((m * (adv - mean) ** 2).sum() / m.sum()) + 1e-8
    r = rowin.numpy().astype(np.float64)
    np.testing.assert_array_equal(r[:, :A], traj["legal"].reshape(n, A))
    np.testing.assert_array_equal(r[:, A:2 * A].argmax(1) + 1, traj["actions"].reshape(n))
    np.testing.assert_array_equal(r[:, A:2 * A].sum(1), np.ones(n))
    np.testing.assert_allclose(r[:, 2 * A + 1], (adv - mean) / std, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r[:, 2 * A + 3], m / m.sum(), rtol=1e-6)
    np.testing.assert_allclose(r[:, 2 * A + 4], VF / n, rtol=1e-6)


def test_kernel_wrappers_refuse_cpu_rows_and_count_launches(ww, pww, traj):
    """A kernel wrapper launches on CUDA tensors only; the CPU entries take
    the plain versions and launch nothing."""
    jcfg, jp = jax_params(ww, "attn")
    cfg = port_cfg(jcfg)
    d = FZ.dims_for(pww, cfg)
    rows, params = rows_of(traj, d), port_params(jp)
    before = (FZ.kernel_forward.launches, FZ.kernel_grads.launches,
              FZ.kernel_loss_grads.launches)
    with pytest.raises(ValueError, match="cuda"):
        FZ.kernel_forward(d, rows, params)
    with pytest.raises(ValueError, match="cuda"):
        FZ.kernel_grads(d, rows, torch.zeros(rows.shape[0], d.A), torch.zeros(rows.shape[0]),
                        params)
    with pytest.raises(ValueError, match="bf16"):
        FZ.host_forward(d, rows.float(), params)
    with pytest.raises(ValueError, match="w_qkv"):
        FZ._flat_params({**params, "w_qkv": params["w_qkv"][:, :5]}, d, rows.device)
    FZ.make_apply(pww, cfg)(params, torch.as_tensor(traj["obs"]))
    after = (FZ.kernel_forward.launches, FZ.kernel_grads.launches,
             FZ.kernel_loss_grads.launches)
    assert after == before
    with pytest.raises(ValueError):
        FZ.make_apply(pww, N.NetConfig(hidden=64, arch="mlp"))
    assert not FZ.supports(pww, N.NetConfig(arch="attn", attn_heads=4))
    assert FZ.supports(pww, N.NetConfig(arch="deepsets"))


def loss_rowin(traj, d, logp_shift=-2.0):
    return FZ._loss_rows(d, torch.as_tensor(traj["legal"]), torch.as_tensor(traj["actions"]),
                         torch.as_tensor(traj["logp_noise"]) + logp_shift,
                         torch.as_tensor(traj["adv"]), torch.as_tensor(traj["ret"]),
                         torch.as_tensor(traj["mask"]), VF)


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
@pytest.mark.parametrize("chunk_rows,nsplit", [(10 ** 6, 1), (7, 5), (64, 2)])
def test_k4_pipeline_matches_plain(ww, pww, traj, arch, chunk_rows, nsplit):
    """K4's stages (csrc/lossgrad.cuh) through the host harness against
    loss_vg_plain, for one chunk, ragged chunks smaller than a product tile
    and several row splits. The products take the same bf16 operands as the
    plain version's, and the cotangents enter them split into hi + lo, so
    the gradients agree far inside the 5e-2 bar (1e-3 here)."""
    jcfg, jp = jax_params(ww, arch)
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    rowin = loss_rowin(traj, d)
    g_ref, s_ref = FZ.loss_vg_plain(d, rows, rowin, params, CLIP, ENT)
    g_k, s_k = FZ.host_loss_grads(d, rows, rowin, params, CLIP, ENT, chunk_rows=chunk_rows,
                                  nsplit=nsplit)
    grads_close({k: v.numpy() for k, v in g_k.items()}, {k: v.numpy() for k, v in g_ref.items()},
                tol=1e-3)
    np.testing.assert_allclose(s_k.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-5)


CHUNKINGS = [(10 ** 6, 1), (7, 5), (64, 2)]


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
@pytest.mark.parametrize("chunk_rows", [c for c, _ in CHUNKINGS])
def test_k2_pipeline_matches_plain(ww, pww, traj, arch, chunk_rows):
    """The tensor-core K2's stages (lg::run_forward through the host
    harness: forward-only layout, no backward buffers) against
    fused_forward_plain for one chunk and ragged chunks, within 5e-3: the
    products add the same bf16 operands in another order, and where that
    flips one of _fwd_body's bf16 roundings the output moves by one bf16
    step (2^-8). The same bits on a repeat and, each row being independent
    of its chunk, at every chunking."""
    jcfg, jp = jax_params(ww, arch)
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    l0, v0 = FZ.fused_forward_plain(d, rows, params)
    l1, v1 = FZ.host_forward(d, rows, params, chunk_rows=chunk_rows)
    assert tuple(l1.shape) == (rows.shape[0], d.A) and tuple(v1.shape) == (rows.shape[0],)
    assert rel_err(l1.numpy(), l0.numpy()) < 5e-3
    assert rel_err(v1.numpy(), v0.numpy()) < 5e-3
    l2, v2 = FZ.host_forward(d, rows, params, chunk_rows=chunk_rows)
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    l3, v3 = FZ.host_forward(d, rows, params, chunk_rows=13)
    assert torch.equal(l1, l3) and torch.equal(v1, v3)


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
@pytest.mark.parametrize("chunk_rows,nsplit", CHUNKINGS)
def test_k3_pipeline_matches_plain(ww, pww, traj, arch, chunk_rows, nsplit):
    """The tensor-core K3 (lg::run_grad with the caller's dl | dv through
    the host harness) against autograd through fused_forward_plain with
    seeded cotangents, every parameter within 1e-3, over ragged chunks and
    1-5 row splits; the same bits on a repeat."""
    jcfg, jp = jax_params(ww, arch)
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    dl, dv = torch.as_tensor(traj["dl"]), torch.as_tensor(traj["dv"])
    rowin = torch.cat([dl, dv[:, None]], 1)
    want = plain_vjp(d, rows, params, dl, dv)
    got = FZ.host_grads(d, rows, rowin, params, chunk_rows=chunk_rows, nsplit=nsplit)
    grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()},
                tol=1e-3)
    again = FZ.host_grads(d, rows, rowin, params, chunk_rows=chunk_rows, nsplit=nsplit)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_k2_and_k4_share_one_forward(ww, pww, traj):
    """K4's loss reads the logits and the value that K2 writes (head_logit,
    head_value in lossgrad.cuh): with one legal action a row the masked
    log-softmax is 0 whatever the logits, so K4's value loss must be K2's
    value against ret, to f32 rounding."""
    jcfg, jp = jax_params(ww, "attn")
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    _, value = FZ.host_forward(d, rows, params, chunk_rows=50)
    n = rows.shape[0]
    ret = torch.as_tensor(traj["ret"]).reshape(n)
    _, stats = FZ.host_loss_grads(d, rows, loss_rowin(traj, d), params, CLIP, ENT,
                                  chunk_rows=50, nsplit=2)
    want = float((0.5 * (value.double() - ret.double()) ** 2).sum() * VF / n)
    assert abs(float(stats[1]) - want) < 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("hidden", [64, 256, 48, 96])
@pytest.mark.parametrize("arch", ["attn", "deepsets"])
def test_k2_k3_route_by_pipeline_coverage(pww, traj, arch, hidden):
    """The pipelines cover every width: K2, K3 and K4 run the tensor-core
    route at multiples of 32 and at widths whose storage they pad (hidden
    48: trunk; hidden 96: hp 48 too), each packing its weights once, and
    agree with the plain versions."""
    cfg = N.NetConfig(hidden=hidden, arch=arch)
    d = FZ.dims_for(pww, cfg)
    assert FZ.supports(pww, cfg)
    params = N.init_params(torch.Generator().manual_seed(1), d.F, d.A, cfg, pww, device="cpu")
    rows = rows_of(traj, d)[:9]
    rowin = torch.cat([torch.as_tensor(traj["dl"]), torch.as_tensor(traj["dv"])[:, None]], 1)[:9]
    packs = FZ._packed.packs
    l1, v1 = FZ.host_forward(d, rows, params)
    g1 = FZ.host_grads(d, rows, rowin, params)
    g4, s4 = FZ.host_loss_grads(d, rows, loss_rowin(traj, d)[:9], params, CLIP, ENT)
    assert FZ._packed.packs == packs + 1  # one packing for the three
    l0, v0 = FZ.fused_forward_plain(d, rows, params)
    assert rel_err(l1.numpy(), l0.numpy()) < 2e-2 and rel_err(v1.numpy(), v0.numpy()) < 2e-2
    want = plain_vjp(d, rows, params, rowin[:, :-1], rowin[:, -1])
    grads_close({k: v.numpy() for k, v in g1.items()}, {k: v.numpy() for k, v in want.items()})
    g_ref, s_ref = FZ.loss_vg_plain(d, rows, loss_rowin(traj, d)[:9], params, CLIP, ENT)
    grads_close({k: v.numpy() for k, v in g4.items()}, {k: v.numpy() for k, v in g_ref.items()})
    np.testing.assert_allclose(s4.numpy(), s_ref.numpy(), rtol=0, atol=5e-2)


def test_k2_scratch_is_forward_only(pww):
    """K2's scratch holds only what its own later stages read: 27,648 bytes
    a row at the attn net's width (hidden 256, hp 128) against K3's and
    K4's ~79 KB, no gradient slabs, and the packed weights (about 1 MB) in a
    buffer of their own."""
    d = FZ.dims_for(pww, N.NetConfig(hidden=256, arch="attn"))
    lib, meta = _build.lossgrad_host_lib(), FZ._meta(d)

    def per_row(nsplit, fwd_only):
        one = lib.lg_scratch_bytes(meta.ctypes.data, 1024, nsplit, fwd_only)
        return (lib.lg_scratch_bytes(meta.ctypes.data, 2048, nsplit, fwd_only) - one) / 1024

    assert per_row(1, 1) == 27648
    assert per_row(1, 1) == per_row(FZ.NSPLIT, 1)  # no slabs
    assert per_row(1, 1) < 0.4 * per_row(1, 0)
    assert lib.lg_scratch_bytes(meta.ctypes.data, FZ.FWD_CHUNK_ROWS, 1, 1) < 2 ** 30
    assert 2 ** 20 <= lib.lg_weights_bytes(meta.ctypes.data) < 2 ** 21
    ds = FZ.dims_for(pww, N.NetConfig(hidden=256, arch="deepsets"))
    assert lib.lg_scratch_bytes(FZ._meta(ds).ctypes.data, 1024, 1, 1) \
        < lib.lg_scratch_bytes(meta.ctypes.data, 1024, 1, 1)


def test_k4_pipeline_ratios_on_both_sides_of_the_clip(ww, pww, traj):
    """At logp_old = the policy's own log-probs + noise the ratios fall
    inside and outside the clip band, so both branches of lax.min's tie
    rule reach the gradient; still within 1e-3 of the plain version."""
    jcfg, jp = jax_params(ww, "attn")
    d = FZ.dims_for(pww, port_cfg(jcfg))
    rows, params = rows_of(traj, d), port_params(jp)
    logits, _ = FZ.fused_forward_plain(d, rows, params)
    legal = torch.as_tensor(traj["legal"]).reshape(-1, d.A)
    lp = torch.log_softmax(torch.where(legal, logits, torch.full_like(logits, -1e9)), -1)
    own = lp.gather(1, torch.as_tensor(traj["actions"]).reshape(-1, 1).long() - 1)[:, 0]
    rowin = FZ._loss_rows(d, torch.as_tensor(traj["legal"]), torch.as_tensor(traj["actions"]),
                          own.reshape(traj["logp_noise"].shape)
                          + torch.as_tensor(traj["logp_noise"]),
                          torch.as_tensor(traj["adv"]), torch.as_tensor(traj["ret"]),
                          torch.as_tensor(traj["mask"]), VF)
    ratio = torch.exp(-torch.as_tensor(traj["logp_noise"]))
    assert bool((ratio > 1 + CLIP).any()) and bool((ratio < 1 - CLIP).any())
    g_ref, s_ref = FZ.loss_vg_plain(d, rows, rowin, params, CLIP, ENT)
    g_k, s_k = FZ.host_loss_grads(d, rows, rowin, params, CLIP, ENT, chunk_rows=33, nsplit=4)
    grads_close({k: v.numpy() for k, v in g_k.items()}, {k: v.numpy() for k, v in g_ref.items()},
                tol=1e-3)
    np.testing.assert_allclose(s_k.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-5)


def test_k4_refuses_what_its_pipeline_does_not_cover(ww, pww, traj):
    """K4 covers hidden 48 (built and run), 40 seats, 65 actions and 33
    trunk layers; what the pipelines refuse is a net past their int32
    parameter addressing or with no trunk layer, and every entry names the
    bound."""
    cfg = N.NetConfig(hidden=48, arch="attn")  # hp = 32, hidden not a multiple of 32
    d = FZ.dims_for(pww, cfg)
    params = N.init_params(torch.Generator().manual_seed(0), d.F, d.A, cfg, pww, device="cpu")
    rowin = loss_rowin(traj, d)
    g_k, s_k = FZ.host_loss_grads(d, rows_of(traj, d), rowin, params, CLIP, ENT, chunk_rows=50)
    g_ref, s_ref = FZ.loss_vg_plain(d, rows_of(traj, d), rowin, params, CLIP, ENT)
    grads_close({k: v.numpy() for k, v in g_k.items()}, {k: v.numpy() for k, v in g_ref.items()})
    assert FZ.supports(pww, cfg)
    FZ.make_loss_vg(pww, cfg, CLIP, VF, ENT)
    for field, value in (("P", 33), ("A", 65), ("layers", 33)):
        assert FZ._bound(dataclasses.replace(d, **{field: value})) is None
    assert "at least one trunk layer, not 0" in FZ._bound(dataclasses.replace(d, layers=0))
    with pytest.raises(ValueError, match="K4 .*at least one trunk layer, not 0"):
        FZ.host_loss_grads(dataclasses.replace(d, layers=0), rows_of(traj, d), rowin, params,
                           CLIP, ENT)
    big = builtin_pair("werewolf", {"max_players": 40}).port
    deep = N.NetConfig(hidden=48, arch="attn", layers=33)
    for lw, c in ((big, cfg), (pww, deep)):
        assert FZ.supports(lw, c) and FZ.unsupported(lw, c) is None
        FZ.make_loss_vg(lw, c, CLIP, VF, ENT)
        FZ.make_apply(lw, c)
    huge = N.NetConfig(hidden=32768, arch="attn", layers=3)  # 3.2e9 parameters
    bound = "MAX_PARAMS = 2147483647 parameters, not"
    assert not FZ.supports(pww, huge) and bound in FZ.unsupported(pww, huge)
    with pytest.raises(ValueError, match=bound):  # refused when built, not when run
        FZ.make_loss_vg(pww, huge, CLIP, VF, ENT)
    with pytest.raises(ValueError, match=bound):
        FZ.make_apply(pww, huge)


# Past what the pipelines held before: a room past a warp of seats (attn,
# 40 seats), past 64 actions (deepsets, 72 seats: A = 72) and a trunk past
# 32 layers (attn, 33 layers at hidden 48)
LARGE = [("attn", 40, 64, 2), ("deepsets", 72, 64, 2), ("attn", 8, 48, 33)]


@pytest.fixture(scope="module")
def large_pairs():
    return {P: builtin_pair("werewolf", {"max_players": P}) for P in (40, 72)}


def port_traj(lw, B=2, T=2, every=6, seed=3):
    """make_traj's inputs from the port's own scripted rollout (a full room
    less three seats), so that no JAX engine compiles at a new seat count."""
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.train.ppo import actor_mask

    eng = BatchedEngine(lw, "cpu")
    st = eng.init(B, lw.P - 3, np.arange(B, dtype=np.uint32) + seed)
    states = []
    for t in range(1, T * every + 1):
        st = eng.step(st, eng.bot_actions(st))
        if t % every == 0:
            states.append(st)
    rng = np.random.default_rng(7)
    obs = np.stack([N.observe(lw, s).float().numpy() for s in states])
    legal = np.stack([N.legal_action_mask(lw, s).numpy() for s in states])
    mask = np.stack([actor_mask(lw, s).numpy() for s in states])
    T, B, P, A = legal.shape
    actions = ((rng.random((T, B, P, A)) * legal).argmax(-1) + 1).astype(np.int32)
    return {"obs": obs, "legal": legal, "mask": mask, "actions": actions,
            "logp_noise": rng.normal(0.0, 0.3, (T, B, P)).astype(np.float32),
            "adv": rng.normal(size=(T, B, P)).astype(np.float32),
            "ret": rng.normal(size=(T, B, P)).astype(np.float32),
            "dl": rng.normal(size=(T * B * P, A)).astype(np.float32),
            "dv": rng.normal(size=(T * B * P,)).astype(np.float32)}


@pytest.mark.parametrize("arch,seats,hidden,layers", LARGE)
def test_large_pipelines_match_jax_kernels(ww, pww, traj, large_pairs, arch, seats, hidden,
                                           layers):
    """test_padded_pipelines_match_jax_kernels past the bounds the pipelines
    had before: the attention's seats past the 32 held in registers, the
    loss's actions past the 64 held in registers and the trunk's layers past
    32, against the JAX kernels in interpret mode at the test_fused_net.py
    tolerances."""
    jww, pw, tr = ((ww, pww, traj) if seats == 8 else
                   (large_pairs[seats].jax, large_pairs[seats].port,
                    port_traj(large_pairs[seats].port)))
    d = FZ.dims_for(pw, N.NetConfig(hidden=hidden, layers=layers, arch=arch))
    assert (d.P, d.layers) == (seats, layers) and (d.A > 64) == (seats == 72)
    check_against_jax_kernels(jww, pw, tr, arch, hidden, layers)


def test_k4_scratch_at_the_main_path_width(pww):
    """K4's scratch per chunk at the attn net's width (hidden 256, hp 128):
    about 79 KB a row, so CHUNK_ROWS rows take under 3 GB beside training."""
    d = FZ.dims_for(pww, N.NetConfig(hidden=256, arch="attn"))
    lib = _build.lossgrad_host_lib()
    assert lib.lg_meta_ints() == len(FZ._meta(d))
    meta = FZ._meta(d)
    one = lib.lg_scratch_bytes(meta.ctypes.data, 1024, FZ.NSPLIT, 0)
    two = lib.lg_scratch_bytes(meta.ctypes.data, 2048, FZ.NSPLIT, 0)
    per_row = (two - one) / 1024
    assert 75_000 <= per_row <= 82_000, per_row
    assert lib.lg_scratch_bytes(meta.ctypes.data, FZ.CHUNK_ROWS, FZ.NSPLIT, 0) < 3 * 2 ** 30
    ds = FZ.dims_for(pww, N.NetConfig(hidden=256, arch="deepsets"))
    small = _build.lossgrad_host_lib().lg_scratch_bytes(FZ._meta(ds).ctypes.data, 1024, 1, 0)
    assert small < one  # no attention buffers without attention


@pytest.mark.parametrize("seats", [8, 40, 72])
def test_scratch_budget_sizes_the_chunks(large_pairs, pww, seats):
    """At the main path's width (attn, hidden 256) a chunk of 8-seat rooms
    stays at CHUNK_ROWS and FWD_CHUNK_ROWS rows; wider rooms take fewer rows
    a chunk (the attention's buffers grow with seats squared), and no
    chunk's scratch passes its budget."""
    lw = pww if seats == 8 else large_pairs[seats].port
    d = FZ.dims_for(lw, N.NetConfig(hidden=256, arch="attn"))
    lib, meta = _build.lossgrad_host_lib(), FZ._meta(d)
    for want, nsplit, fwd, budget in ((FZ.CHUNK_ROWS, FZ.NSPLIT, 0, FZ.SCRATCH_BUDGET),
                                      (FZ.FWD_CHUNK_ROWS, 1, 1, FZ.FWD_SCRATCH_BUDGET)):
        chunk = FZ._chunk(lib, meta, 10 ** 6, want, nsplit, fwd)
        assert lib.lg_scratch_bytes(meta.ctypes.data, chunk, nsplit, fwd) <= budget
        assert (chunk == want) == (seats == 8), chunk
        assert lib.lg_scratch_bytes(meta.ctypes.data, int(chunk * 1.1) + 1, nsplit, fwd) > budget \
            or chunk == want
