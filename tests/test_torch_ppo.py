"""The PyTorch port's PPO learner (game_engine_tpu_torch/train/) against the
JAX package's train/ppo.py on the CPU:

  actor_mask, terminal_rewards, team_masks   exact, on states of JAX
                                             scripted rollouts (team,
                                             speaker/score and survivor games)
  gae                                        within 1e-6
  ppo_loss + autograd                        vs jax.value_and_grad(ppo_loss):
                                             loss 2e-2, metrics 5e-2 abs,
                                             grads 5e-2 of the max |grad|
  one Adam update                            param deltas within 5e-2 of
                                             optax.adam's, of the max |delta|

and train.run.main end to end on the CPU (attn and deepsets), with its
checkpoint written and resumed."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.train import run as R
from tests.test_torch_fused import logp_old, make_traj
from tests.test_torch_net import CKPT, host_state, port_cfg, port_params, rel_err
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("mlp", "deepsets", "attn")


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


@pytest.mark.parametrize("game", ["werewolf", "two-truths-and-a-lie", "last-stand"])
def test_masks_and_rewards_exact(game):
    pair = builtin_pair(game)
    lw, plw = pair.jax, pair.port
    B, n = 8, min(lw.P, 6)
    eng = JaxBatchedEngine(lw)
    st = jax_init_state(lw, B, n, np.arange(B, dtype=np.uint32) + 21)
    ended_seen = 0
    for _ in range(60):
        tst = host_state(st)
        np.testing.assert_array_equal(P.actor_mask(plw, tst).numpy(),
                                      np.asarray(JP.actor_mask(lw, st)))
        np.testing.assert_array_equal(P.team_masks(plw, tst).numpy(),
                                      np.asarray(JP.team_masks(lw, st)))
        nxt = eng.step(st, eng.bot_actions(st))
        ended = nxt.done & ~st.done
        got = P.terminal_rewards(plw, host_state(nxt), torch.as_tensor(np.asarray(ended)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JP.terminal_rewards(lw, nxt, ended)))
        ended_seen += int(np.asarray(ended).sum())
        st = nxt
    assert ended_seen > 0, "no episode ended: rewards were only checked at zero"


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    T, B, Pn = 7, 5, 4
    value = rng.normal(size=(T, B, Pn)).astype(np.float32)
    reward = (rng.random((T, B, Pn)) < 0.2) * rng.choice([-1.0, 1.0], (T, B, Pn))
    done = rng.random((T, B)) < 0.25
    last = rng.normal(size=(B, Pn)).astype(np.float32)
    cfg = P.PPOConfig()
    jt = JP.Rollout(None, None, None, jnp.asarray(value), jnp.asarray(reward, jnp.float32),
                    jnp.asarray(done), None, None)
    ja, jr = JP.gae(jt, jnp.asarray(last), JP.PPOConfig())
    tt = P.Rollout(None, None, None, torch.as_tensor(value),
                   torch.as_tensor(reward.astype(np.float32)), torch.as_tensor(done), None, None)
    ta, tr = P.gae(tt, torch.as_tensor(last), cfg)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def _rollouts(ww, jcfg, jp):
    """The same trajectory as a JAX and a port Rollout, with adv and ret."""
    tr = make_traj(ww)
    lp = logp_old(tr, jp, jcfg, ww)
    obs = jnp.asarray(tr["obs"], jnp.bfloat16)
    jt = JP.Rollout(obs=obs, actions=jnp.asarray(tr["actions"]), logp=jnp.asarray(lp),
                    value=None, reward=None, done=None, mask=jnp.asarray(tr["mask"]),
                    legal=jnp.asarray(tr["legal"]))
    tt = P.Rollout(obs=torch.as_tensor(tr["obs"]).bfloat16(),
                   actions=torch.as_tensor(tr["actions"]), logp=torch.as_tensor(lp),
                   value=None, reward=None, done=None, mask=torch.as_tensor(tr["mask"]),
                   legal=torch.as_tensor(tr["legal"]))
    j_ar = (jnp.asarray(tr["adv"]), jnp.asarray(tr["ret"]))
    t_ar = (torch.as_tensor(tr["adv"]), torch.as_tensor(tr["ret"]))
    return jt, j_ar, tt, t_ar


def _setup(ww, arch):
    jcfg = JN.NetConfig(hidden=64, arch=arch)
    jp = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww), jcfg, ww)
    return jcfg, jp, P.PPOConfig(net=port_cfg(jcfg), loss_chunk=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_ppo_loss_matches_jax_value_and_grad(ww, pww, arch):
    jcfg, jp, cfg = _setup(ww, arch)
    jt, (jadv, jret), tt, (tadv, tret) = _rollouts(ww, jcfg, jp)
    (l_x, m_x), g_x = jax.value_and_grad(
        lambda p: JP.ppo_loss(p, jt, jadv, jret, JP.PPOConfig(net=jcfg), ww), has_aux=True)(jp)
    params = {k: v.requires_grad_(True) for k, v in port_params(jp).items()}
    loss, metrics = P.ppo_loss(params, tt, tadv, tret, cfg, pww)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - float(l_x)) / (abs(float(l_x)) + 1e-6) < 2e-2
    for k in ("pg_loss", "v_loss", "entropy", "ratio_mean"):
        assert abs(float(metrics[k].detach()) - float(m_x[k])) < 5e-2, k
    for k, g in zip(params, grads):
        assert rel_err(g.numpy(), np.asarray(g_x[k])) < 5e-2, (k, rel_err(g.numpy(), g_x[k]))


def test_adam_update_matches_optax(ww, pww):
    """make_update (ppo_loss, autograd, torch.optim.Adam) against
    value_and_grad + optax.adam, one step from the same params and
    trajectory. Adam's first step is lr * g / (|g| + eps), full size
    whatever |g|, so a weight whose gradient lies within the gradient
    tolerance (5e-2 of the max) of 0 may step either way: those are left
    out. Given JAX's own gradients, torch's Adam steps as optax's does, to
    1e-3 of a step (the float32 rounding of the params)."""
    jcfg, jp, cfg = _setup(ww, "attn")
    jt, (jadv, jret), tt, (tadv, tret) = _rollouts(ww, jcfg, jp)
    tx = optax.adam(cfg.lr)
    g_x = jax.grad(lambda p: JP.ppo_loss(p, jt, jadv, jret, JP.PPOConfig(net=jcfg), ww)[0])(jp)
    upd, _ = tx.update(g_x, tx.init(jp), jp)
    want = {k: np.asarray(optax.apply_updates(jp, upd)[k]) - np.asarray(jp[k]) for k in jp}

    params = port_params(jp)
    before = {k: v.clone() for k, v in params.items()}
    opt = P.make_optimizer(params, cfg)
    loss, _ = P.make_update(pww, cfg)(params, opt, tt, tadv, tret)
    assert np.isfinite(float(loss))
    for k in jp:
        got = (params[k].detach() - before[k]).numpy()
        g = np.abs(np.asarray(g_x[k]))
        keep = g >= 5e-2 * g.max()
        assert rel_err(got[keep], want[k][keep]) < 5e-2, (k, rel_err(got[keep], want[k][keep]))

    same = port_params(jp)
    opt = P.make_optimizer(same, cfg)
    for k, p in same.items():
        p.grad = torch.as_tensor(np.asarray(g_x[k]))
    opt.step()
    for k in jp:
        got = (same[k].detach() - before[k]).numpy()
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-3 * cfg.lr)


def run_main(argv):
    """train.run.main's params and its JSON event lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params = R.main(argv)
    return params, [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
def test_train_run_main_on_cpu(pww, arch):
    argv = ["--device", "cpu", "--arch", arch, "--hidden", "64", "--batch", "8", "--horizon",
            "4", "--epochs", "1", "--updates", "2", "--eval-batch", "8"]
    params, events = run_main(argv)
    cfg = N.NetConfig(hidden=64, arch=arch)
    init = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(pww), N.action_space(pww),
                         cfg, pww, device="cpu")
    assert any(float((params[k].detach() - init[k]).abs().max()) > 0 for k in init)
    train = [e for e in events if e["event"] == "train"]
    assert len(train) == 1 and train[0]["update"] == 2
    for k in ("loss", "pg_loss", "v_loss", "entropy", "ratio_mean", "steps_per_sec",
              "unroll_ms", "update_ms"):
        assert np.isfinite(train[0][k]), k
    evals = [e for e in events if e["event"] == "eval"]
    assert [e["update"] for e in evals] == [0, 2]
    assert {"learned_as_minority", "learned_as_majority"} <= set(evals[-1])
    assert not any(e["event"] == "fused_net" for e in events)  # auto: off on the CPU


@pytest.mark.parametrize("hidden,forward,loss", [(48, "tensor_core", "k4"),
                                                 (96, "tensor_core", "k4"),
                                                 (64, "tensor_core", "k4")])
def test_fused_train_step_routes_the_loss_by_k4_coverage(pww, hidden, forward, loss):
    """The fused train path takes K4 at every width, also where the
    pipelines pad the storage (hidden 48: trunk not a multiple of 32;
    hidden 96: hp 48); run.main says which forward and which loss it
    runs."""
    cfg = P.PPOConfig(horizon=2, epochs=1, fused_net=True,
                      net=N.NetConfig(hidden=hidden, arch="attn"))
    assert (P.make_loss_vg_fn(pww, cfg) is not None) == (loss == "k4")
    argv = ["--device", "cpu", "--arch", "attn", "--hidden", str(hidden), "--batch", "4",
            "--horizon", "2", "--epochs", "1", "--updates", "1", "--eval-batch", "0", "--fused"]
    params, events = run_main(argv)
    assert [e for e in events if e["event"] == "fused_net"] == [
        {"event": "fused_net", "mode": "forced", "disable_with": "--no-fused",
         "forward": forward, "loss": loss}]
    init = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(pww), N.action_space(pww),
                         cfg.net, pww, device="cpu")
    assert any(float((params[k].detach() - init[k]).abs().max()) > 0 for k in init)
    assert np.isfinite([e for e in events if e["event"] == "train"][0]["loss"])


def test_forced_fused_refuses_a_net_the_kernels_do_not_cover():
    """--fused on a net the kernels do not cover raises, naming why, before
    any training; it does not train through apply_net instead."""
    argv = ["--device", "cpu", "--arch", "mlp", "--hidden", "32", "--batch", "4",
            "--horizon", "2", "--updates", "1", "--eval-batch", "0", "--fused"]
    with pytest.raises(ValueError, match="--fused: the kernels cover deepsets/attn"):
        run_main(argv)


def test_auto_fused_raises_on_the_card_for_a_net_past_the_bounds(monkeypatch):
    """Left to choose (no --fused, no --no-fused) on the card, run.py takes
    the kernels for a net of an arch they cover, and one past their bound
    (the int32 addressing of the flat parameters) raises there, naming it,
    before any training: the plain net does not take the kernels' place
    unasked. (The card is stood in for: the device resolves to cuda and
    MAX_PARAMS is lowered below the net's count; the raise comes before
    anything touches the device.)"""
    from game_engine_tpu_torch import device as D

    monkeypatch.setattr(D, "resolve", lambda device: torch.device("cuda"))
    monkeypatch.setattr(FZ, "MAX_PARAMS", 1000)
    argv = ["--device", "cuda", "--arch", "attn", "--hidden", "48", "--batch", "4",
            "--horizon", "2", "--updates", "1", "--eval-batch", "0"]
    with pytest.raises(ValueError, match="MAX_PARAMS = 1000 parameters, not"):
        run_main(argv)


def test_kernel_choice_refuses_nets_past_the_bounds_and_passes_other_archs():
    """runs_on_card: the kernels on the card for a covered arch (40 seats
    and 33 trunk layers included, as the JAX kernels), nothing on the CPU
    or for another arch (mlp, multi-head attn: apply_net, as in JAX), and a
    raise naming the bound for a covered net past it on the card (more
    parameters than int32 offsets address). PPOConfig(fused_net=True)
    forces the kernels: at 40 seats make_apply_fn and make_loss_vg_fn build
    them, past the bound they raise on any device; an mlp net still trains
    through apply_net."""
    pww = builtin_pair("werewolf").port
    big = builtin_pair("werewolf", {"max_players": 40}).port
    attn, mlp = N.NetConfig(hidden=48, arch="attn"), N.NetConfig(hidden=48, arch="mlp")
    assert FZ.runs_on_card(pww, attn, "cuda") and FZ.runs_on_card(big, attn, "cuda")
    assert not FZ.runs_on_card(pww, attn, "cpu") and not FZ.runs_on_card(big, attn, "cpu")
    assert not FZ.runs_on_card(big, mlp, "cuda")
    assert not FZ.runs_on_card(pww, N.NetConfig(arch="attn", attn_heads=2), "cuda")
    deep = N.NetConfig(hidden=48, arch="deepsets", layers=33)
    assert FZ.runs_on_card(pww, deep, "cuda")
    huge = N.NetConfig(hidden=32768, arch="deepsets", layers=3)
    with pytest.raises(ValueError, match="MAX_PARAMS = 2147483647 parameters, not"):
        FZ.runs_on_card(pww, huge, "cuda")
    forced = P.PPOConfig(fused_net=True, net=attn)
    assert P.make_apply_fn(big, forced) is not None
    assert P.make_loss_vg_fn(big, forced) is not None
    too_big = P.PPOConfig(fused_net=True, net=huge)
    with pytest.raises(ValueError, match="MAX_PARAMS = 2147483647 parameters"):
        P.make_apply_fn(big, too_big)
    with pytest.raises(ValueError, match="K4: .*MAX_PARAMS = 2147483647 parameters"):
        P.make_loss_vg_fn(big, too_big)
    plain = P.PPOConfig(fused_net=True, net=mlp)
    assert P.make_loss_vg_fn(big, plain) is None
    d = FZ.dims_for(big, mlp)
    params = N.init_params(torch.Generator().manual_seed(0), d.F, d.A, mlp, big, device="cpu")
    obs = torch.zeros((2, d.P, d.F))
    logits, _ = P.make_apply_fn(big, plain)(params, obs)
    want, _ = N.apply_net(params, obs, mlp, big)
    assert torch.equal(logits, want)


def _cache_setup(pww, arch="attn"):
    cfg = P.PPOConfig(net=N.NetConfig(hidden=64, arch=arch))
    params, opt = P.init_training(pww, cfg, torch.Generator().manual_seed(4), device="cpu")
    d = FZ.dims_for(pww, cfg.net)
    rng = np.random.default_rng(12)
    rows = torch.as_tensor(rng.random((10, d.F)).astype(np.float32)).bfloat16().contiguous()
    return cfg, params, opt, d, rows


def _forward_checked(d, rows, params):
    """The pipeline's forward (packed weights from the cache), held to the
    plain version on the parameters of this moment."""
    logits, value = FZ.host_forward(d, rows, params)
    lp, vp = FZ.fused_forward_plain(d, rows, {k: v.detach() for k, v in params.items()})
    assert rel_err(logits.numpy(), lp.numpy()) < 5e-3
    assert rel_err(value.numpy(), vp.numpy()) < 5e-3
    return logits, value


def test_packed_weights_pack_once_while_params_are_unchanged(pww):
    """The pipelines pack the weights to bf16 once per parameter state: K2's
    repeated calls of an unroll, then K3 on the same state, reuse one
    packing; another parameter set of the same shape packs anew."""
    _, params, _, d, rows = _cache_setup(pww)
    packs = FZ._packed.packs
    first = _forward_checked(d, rows, params)
    assert FZ._packed.packs == packs + 1
    for _ in range(3):
        again = FZ.host_forward(d, rows, params)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    FZ.host_grads(d, rows, torch.ones(rows.shape[0], d.A + 1), params)
    assert FZ._packed.packs == packs + 1
    other = {k: v.detach().clone() for k, v in params.items()}
    with torch.no_grad():
        other["b_v"] += 1.0
    moved = _forward_checked(d, rows, other)
    assert FZ._packed.packs == packs + 2
    assert not torch.equal(moved[1], first[1])


@pytest.mark.parametrize("name", ["w_phi1", "b_pi", "w_v"])
def test_packed_weights_follow_an_in_place_add(pww, name):
    """An in-place update of one parameter (a packed weight or a bias read
    from the flat f32 copy) changes the next forward."""
    _, params, _, d, rows = _cache_setup(pww)
    before = _forward_checked(d, rows, params)
    packs = FZ._packed.packs
    with torch.no_grad():
        params[name].add_(0.25)
    after = _forward_checked(d, rows, params)
    assert FZ._packed.packs == packs + 1
    assert not (torch.equal(after[0], before[0]) and torch.equal(after[1], before[1]))


@pytest.mark.parametrize("arch", ["attn", "deepsets"])
def test_packed_weights_follow_an_adam_step(pww, arch):
    """torch.optim.Adam updates the parameters in place, at the same
    addresses: the forward after a step is the new parameters', not the
    packing of the old ones."""
    cfg, params, opt, d, rows = _cache_setup(pww, arch)
    before = _forward_checked(d, rows, params)
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    assert ptrs == {k: v.data_ptr() for k, v in params.items()}
    after = _forward_checked(d, rows, params)
    assert not torch.equal(after[0], before[0]) and not torch.equal(after[1], before[1])


def test_train_run_checkpoint_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--arch", "attn", "--hidden", "64", "--batch", "4", "--horizon",
            "2", "--epochs", "1", "--updates", "1", "--eval-batch", "0"]
    params, _ = run_main(argv + ["--checkpoint", ck, "--eval-every", "1"])
    saved, cfg = N.load_policy(ck + "_u1.npz", device="cpu")
    assert cfg == N.NetConfig(hidden=64, arch="attn")
    assert all(torch.equal(saved[k], params[k].detach()) for k in params)
    back, events = run_main(argv[:-4] + ["--updates", "0", "--eval-batch", "0",
                                         "--resume", ck + "_u1.npz"])
    assert {"event": "resume", "from": ck + "_u1.npz"} in events
    assert all(torch.equal(back[k].detach(), params[k].detach()) for k in params)
    # the shipped full-width checkpoint resumes at its own width
    full, _ = run_main(["--device", "cpu", "--arch", "attn", "--hidden", "256", "--batch",
                        "2", "--updates", "0", "--eval-batch", "0", "--resume", CKPT])
    shipped, _ = N.load_policy(CKPT, device="cpu")
    assert all(torch.equal(full[k].detach(), shipped[k]) for k in shipped)
    with pytest.raises(ValueError, match="--resume"):
        run_main(["--device", "cpu", "--arch", "attn", "--hidden", "64", "--updates", "0",
                  "--eval-batch", "0", "--resume", CKPT])


def test_train_run_device_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(["--device", "cuda", "--updates", "0", "--eval-batch", "0"])
