"""The port's multi-device layer (game_engine_tpu_torch/parallel/,
train/ppo.py with a mesh, graft_entry.py) on the CPU: ranks are processes
of a gloo world started by parallel.launch.run_ranks, one torch thread
each, with inputs made from seeded numpy generators.

  sharding         params_sharding and state_sharding equal the JAX
                   functions' addressable_shards on conftest's 8-device CPU
                   mesh, exactly, at (4, 2) and (8, 1)
  engine dp        2 and 4 ranks step their rooms 60 scripted steps: the
                   gathered state equals one process on all rooms, bit for
                   bit (the twin of test_multichip.py)
  tp               apply_net and the ppo_loss gradients over a model axis of
                   2, gathered, against the unsharded port, and within
                   test_torch_ppo.py's tolerances of JAX's value_and_grad
                   under params_sharding on a (4, 2) mesh
  dp loss-grad     2 and 4 ranks on one trajectory whose mask sums differ by
                   rank: the summed gradients against one process, through
                   K4's plain version (loss_vg_plain on _loss_rows'
                   whole-batch row weights) and through autograd, and
                   within the tolerances of JAX's

Tolerances against the unsharded port: the loss, metrics, logits and
values within 1e-4 (relative), and so the gradients of K4's route, whose
cotangents stay f32. The autograd net rounds to bf16 after sums that the
ranks take in another order: tp's partial products before the next
layer's cast and the summed cotangent of a column-split layer's input. One
bf16 step is 2^-8 of a value, and partial sums that cancel can enlarge it,
so those gradients are held within 1e-3 of the largest: measured 1.9e-4
at (1, 2) with 3 layers, where JAX's own sharded gradients move by 9.4e-5
from its unsharded ones. Under dp each weight cotangent is summed over the
data group before its bf16 rounding (net._BfSumOverData), as JAX's GSPMD
program does: 1.8e-7 at (2, 2), 7.1e-5 for the attn net at dp = 2 and 4.
Rounding each rank's cotangent before the sum moved them by 5.9e-3.
  spread           how far sharding moves the autograd net's gradients,
                   JAX's against its unsharded ones and the port's against
                   its own, at (2, 2) and at (1, 2) with 3 layers
  dp train step    a mesh of one rank is today's make_train_step bit for
                   bit over 2 updates; at 2 and 4 ranks the rooms after the
                   first unroll equal one rank's exactly
  dryrun           dryrun_multichip(4) on a (2, 2) mesh finishes episodes;
                   the scaling curve at 2 ranks
  launcher         a failing rank fails the call, a late one its timeout;
                   stop_fork_server leaves no process of the launcher alive
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as JP_

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.parallel import mesh as JM
from game_engine_tpu.policies import net as JN
from game_engine_tpu.train import ppo as JP
from game_engine_tpu_torch import graft_entry as G
from game_engine_tpu_torch.core.engine import make_rollout
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.parallel import mesh as M
from game_engine_tpu_torch.parallel import parity
from game_engine_tpu_torch.parallel.launch import run_ranks, stop_fork_server
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P
from tests.test_torch_net import host_state, jax_states, port_params, rel_err
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

T_, B_ = 3, 8  # the fixed trajectory: 3 steps of 8 rooms


@pytest.fixture(scope="module")
def ww_pair():
    return builtin_pair("werewolf")


@pytest.fixture(scope="module")
def ww(ww_pair):
    return ww_pair.jax


@pytest.fixture(scope="module")
def pww(ww_pair):
    return ww_pair.port


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# sharding rules against JAX's addressable shards
# ---------------------------------------------------------------------------

def _rank_of(jmesh, device) -> int:
    """The port's rank of a JAX device: its place in the mesh grid in
    row-major order, as make_mesh reshapes."""
    return int(np.argwhere(jmesh.devices == device)[0] @ np.array([jmesh.devices.shape[1], 1]))


def _port_mesh(jmesh, rank: int) -> M.Mesh:
    return M.Mesh(np.arange(jmesh.devices.size).reshape(jmesh.devices.shape), rank, device="cpu")


@pytest.mark.parametrize("grid", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
@pytest.mark.parametrize("arch", ["mlp", "attn"])
def test_params_sharding_equals_jax_shards(ww, grid, arch):
    jcfg = JN.NetConfig(hidden=64, layers=3, arch=arch)
    jp = JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww), jcfg, ww)
    jmesh = JM.make_mesh(8, model_parallel=grid[1])
    sharded = JM.params_sharding(jmesh, jp)
    full = port_params(jp)
    for rank in range(8):
        assert _port_mesh(jmesh, rank).coords == (rank // grid[1], rank % grid[1])
    split = {"model": 0, "replicated": 0}
    for k, arr in sharded.items():
        for shard in arr.addressable_shards:
            mine = M.params_sharding(_port_mesh(jmesh, _rank_of(jmesh, shard.device)), full)[k]
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), err_msg=k)
        split["model" if "model" in M.param_spec(k, arr.ndim) else "replicated"] += 1
    assert split["model"] == 5 and split["replicated"] > 0  # w0 b0 w1 w2 b2


@pytest.mark.parametrize("grid", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_state_sharding_equals_jax_shards(ww, grid):
    B = 16
    eng = JaxBatchedEngine(ww)
    st = jax_init_state(ww, B, 6, np.arange(B, dtype=np.uint32) + 5)
    for _ in range(7):
        st = eng.step(st, eng.bot_actions(st))
    jmesh = JM.make_mesh(8, model_parallel=grid[1])
    sharded = JM.state_sharding(jmesh, st)
    port = host_state(st)
    for f in GameState._fields:
        for shard in getattr(sharded, f).addressable_shards:
            mine = M.state_sharding(_port_mesh(jmesh, _rank_of(jmesh, shard.device)), port)
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(shard.data).astype(
                                              getattr(mine, f).numpy().dtype), err_msg=f)


def test_sharding_refuses_an_uneven_split(pww):
    mesh = M.Mesh(np.arange(4).reshape(4, 1), 1, device="cpu")
    with pytest.raises(ValueError, match="does not split evenly"):
        M.state_sharding(mesh, init_state(pww, 6, 6, 0, device="cpu"))
    with pytest.raises(ValueError, match="does not split evenly"):
        M.params_sharding(M.Mesh(np.arange(6).reshape(2, 3), 0, device="cpu"),
                          {"w0": torch.zeros(4, 8)})


# ---------------------------------------------------------------------------
# the engine over data ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("game,ranks", [("werewolf", 2), ("werewolf", 4), ("two-truths", 2)])
def test_engine_dp_equals_one_process(game, ranks):
    spec = {"game": game, "rooms": 16, "seats": 6, "steps": 60, "device": "cpu"}
    out = run_ranks(parity.engine_rollout, ranks, spec, device="cpu")
    ref, ref_eps = make_rollout(parity.lowered_of(game), 60)(parity.start_of(spec, "cpu"))
    assert [r["coords"] for r in out] == [(r, 0) for r in range(ranks)]
    assert int(ref_eps) > 0, "no episodes completed in the test window"
    for f, want in zip(GameState._fields, ref):
        joined = np.concatenate([getattr(r["state"], f) for r in out])
        np.testing.assert_array_equal(joined, want.numpy(), err_msg=f)
        for r in out:  # every rank gathered all rooms
            np.testing.assert_array_equal(getattr(r["gathered"], f), want.numpy(), err_msg=f)
    assert all(r["episodes"] == int(ref_eps) for r in out)


# ---------------------------------------------------------------------------
# a fixed trajectory: tp and dp loss-grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traj(ww):
    """(T=3, B=8) of a JAX scripted rollout with PPO inputs from a seeded
    numpy generator. Rooms 0-2 carry no actor mask, so the mask's sums
    differ between the ranks of every split."""
    states = jax_states(ww, B=B_, n=6, steps=30, every=10, seed=3)[1:]
    rng = np.random.default_rng(7)
    obs = np.stack([np.asarray(JN.observe(ww, s).astype(jnp.float32)) for s in states])
    legal = np.stack([np.asarray(JN.legal_action_mask(ww, s)) for s in states])
    mask = np.stack([np.asarray(JP.actor_mask(ww, s)) for s in states])
    mask[:, :3] = False
    actions = ((rng.random(legal.shape) * legal).argmax(-1) + 1).astype(np.int32)
    for ranks in (2, 4):
        sums = mask.reshape(T_, ranks, B_ // ranks, -1).sum((0, 2, 3))
        assert len(set(sums.tolist())) > 1, sums
    return {"obs": obs, "legal": legal, "mask": mask, "actions": actions,
            "logp": rng.normal(-1.5, 0.3, mask.shape).astype(np.float32),
            "adv": rng.normal(size=mask.shape).astype(np.float32),
            "ret": rng.normal(size=mask.shape).astype(np.float32)}


def _jax_params(ww, arch, layers):
    jcfg = JN.NetConfig(hidden=64, layers=layers, arch=arch)
    return jcfg, JN.init_params(jax.random.PRNGKey(0), JN.obs_dim(ww), JN.action_space(ww),
                                jcfg, ww)


def _port_traj(tr):
    return (P.Rollout(obs=torch.as_tensor(tr["obs"]).bfloat16(),
                      actions=torch.as_tensor(tr["actions"]), logp=torch.as_tensor(tr["logp"]),
                      value=None, reward=None, done=None, mask=torch.as_tensor(tr["mask"]),
                      legal=torch.as_tensor(tr["legal"])),
            torch.as_tensor(tr["adv"]), torch.as_tensor(tr["ret"]))


def _jax_value_and_grad(ww, jcfg, jp, tr, jmesh=None):
    """JAX's value_and_grad(ppo_loss), under params_sharding and the rooms
    on 'data' when a mesh is given."""
    jt = JP.Rollout(obs=jnp.asarray(tr["obs"], jnp.bfloat16), actions=jnp.asarray(tr["actions"]),
                    logp=jnp.asarray(tr["logp"]), value=None, reward=None, done=None,
                    mask=jnp.asarray(tr["mask"]), legal=jnp.asarray(tr["legal"]))
    adv, ret = jnp.asarray(tr["adv"]), jnp.asarray(tr["ret"])
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, a, r: JP.ppo_loss(p, t, a, r, JP.PPOConfig(net=jcfg), ww), has_aux=True))
    if jmesh is None:
        return fn(jp, jt, adv, ret)

    def rooms(x):
        spec = [None] * x.ndim
        spec[1] = "data"
        return jax.device_put(x, NamedSharding(jmesh, JP_(*spec)))

    with jmesh:
        return fn(JM.params_sharding(jmesh, jp),
                  jax.tree_util.tree_map(rooms, jt), rooms(adv), rooms(ret))


def _check_jax(loss, metrics, grads, jout):
    (l_x, m_x), g_x = jout
    assert abs(float(loss) - float(l_x)) / (abs(float(l_x)) + 1e-6) < 2e-2
    for k in ("pg_loss", "v_loss", "entropy", "ratio_mean"):
        assert abs(float(metrics[k]) - float(m_x[k])) < 5e-2, k
    for k, g in grads.items():
        assert rel_err(g, np.asarray(g_x[k])) < 5e-2, (k, rel_err(g, np.asarray(g_x[k])))


def _reference(pww, cfg, params_np, tr):
    """The unsharded port: loss, metrics, gradients and the net's outputs."""
    params = {k: v.requires_grad_(True) for k, v in
              N.params_from_numpy(params_np, device="cpu").items()}
    t, adv, ret = _port_traj(tr)
    loss, metrics, grads = P.make_grad_fn(pww, cfg)(params, t, adv, ret)
    with torch.no_grad():
        logits, value = P.make_apply_fn(pww, cfg)(params, t.obs)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {k: g.numpy() for k, g in grads.items()}, logits, value)


def _spec(jcfg, jp, tr, n, model, fused=False):
    return {"game": "werewolf", "net": {"hidden": jcfg.hidden, "layers": jcfg.layers,
                                        "arch": jcfg.arch},
            "ppo": {"fused_net": fused, "loss_chunk": 2}, "params": _np(jp), "traj": tr,
            "n": n, "model": model, "device": "cpu"}


TOL = 1e-4          # sums over ranks in another order, f32 throughout
TOL_BF16_AFTER_SUM = 1e-3  # tp: the autograd net's bf16 casts after reordered sums


def _check_ranks(out, ref, n, model, grad_tol, tol=TOL):
    loss, metrics, grads, logits, value = ref
    for r in out:
        assert abs(float(r["loss"]) - loss) <= tol * abs(loss), (r["loss"], loss)
        for k, v in metrics.items():
            assert abs(float(r["metrics"][k]) - v) <= tol * max(abs(v), 1e-3), k
        for k, g in grads.items():
            assert rel_err(r["grads"][k], g) < grad_tol, (k, rel_err(r["grads"][k], g))
    rows = B_ // (n // model)
    for r in out:
        lo = r["coords"][0] * rows
        assert rel_err(r["logits"], logits[:, lo:lo + rows].numpy()) < tol
        assert rel_err(r["value"], value[:, lo:lo + rows].numpy()) < tol


@pytest.mark.parametrize("layers,grid", [(2, (1, 2)), (3, (1, 2)), (2, (2, 2))],
                         ids=["2layers-1x2", "3layers-1x2", "2layers-2x2"])
def test_tp_forward_and_grads_equal_unsharded(ww, pww, traj, layers, grid):
    jcfg, jp = _jax_params(ww, "mlp", layers)
    n = grid[0] * grid[1]
    spec = _spec(jcfg, jp, traj, n, grid[1])
    out = run_ranks(parity.loss_grad, n, spec, device="cpu")
    assert [r["coords"] for r in out] == [(r // grid[1], r % grid[1]) for r in range(n)]
    cfg = parity.config_of(spec)
    _check_ranks(out, _reference(pww, cfg, _np(jp), traj), n, grid[1], TOL_BF16_AFTER_SUM)


def _grad_spread(grads, ref) -> float:
    return max(rel_err(np.asarray(grads[k]), np.asarray(ref[k])) for k in ref)


@pytest.mark.parametrize("layers,grid", [(2, (2, 2)), (3, (1, 2))],
                         ids=["2layers-2x2", "3layers-1x2"])
def test_sharded_grads_move_no_further_than_jax_own(ww, pww, traj, layers, grid):
    """How far sharding moves the autograd net's gradients from one
    process's: JAX's value_and_grad under params_sharding with the rooms on
    'data' against its unsharded one, and the port's ranks against the
    unsharded port, at the shape and seed of
    test_tp_forward_and_grads_equal_unsharded. Measured on the CPU: JAX
    4.2e-7 at (2, 2) and 9.4e-5 at (1, 2) with 3 layers; the port 1.8e-7
    and 1.9e-4 (5.9e-3 at (2, 2) while each rank rounded its weight
    cotangents to bf16 before the data group's sum). The port is held
    within 4x JAX's spread, or 1e-6 where JAX's is below a float32 step."""
    jcfg, jp = _jax_params(ww, "mlp", layers)
    n = grid[0] * grid[1]
    (_, g_one) = _jax_value_and_grad(ww, jcfg, jp, traj)
    (_, g_sh) = _jax_value_and_grad(ww, jcfg, jp, traj, JM.make_mesh(n, model_parallel=grid[1]))
    jax_spread = _grad_spread(g_sh, g_one)
    spec = _spec(jcfg, jp, traj, n, grid[1])
    out = run_ranks(parity.loss_grad, n, spec, device="cpu")
    ref = _reference(pww, parity.config_of(spec), _np(jp), traj)[2]
    port_spread = max(_grad_spread(r["grads"], ref) for r in out)
    assert jax_spread < 1e-4, jax_spread
    assert port_spread <= max(4 * jax_spread, 1e-6), (port_spread, jax_spread)


@pytest.mark.parametrize("layers", [2, 3])
def test_tp_grads_equal_jax_under_params_sharding(ww, traj, layers):
    """JAX's value_and_grad(ppo_loss) with params_sharding on a (4, 2) mesh
    against the port's over a (1, 2) mesh of ranks."""
    jcfg, jp = _jax_params(ww, "mlp", layers)
    out = run_ranks(parity.loss_grad, 2, _spec(jcfg, jp, traj, 2, 2), device="cpu")
    jout = _jax_value_and_grad(ww, jcfg, jp, traj, JM.make_mesh(8, model_parallel=2))
    for r in out:
        _check_jax(r["loss"], r["metrics"], r["grads"], jout)


@pytest.fixture(scope="module")
def attn_jax(ww, traj):
    jcfg, jp = _jax_params(ww, "attn", 2)
    return jcfg, jp, _jax_value_and_grad(ww, jcfg, jp, traj, JM.make_mesh(8, model_parallel=1))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("route", ["autograd", "k4_plain"])
def test_dp_loss_grad_equals_one_process_and_jax(pww, traj, attn_jax, route, ranks):
    """The data group's summed gradients of the attn net. k4_plain: the
    fused update's route on the CPU, K4's plain version on _loss_rows, whose
    msum, advantage moments and n are the whole batch's."""
    jcfg, jp, jout = attn_jax
    spec = _spec(jcfg, jp, traj, ranks, 1, fused=route == "k4_plain")
    cfg = parity.config_of(spec)
    assert (P.make_loss_vg_fn(pww, cfg) is not None) == (route == "k4_plain")
    out = run_ranks(parity.loss_grad, ranks, spec, device="cpu")
    _check_ranks(out, _reference(pww, cfg, _np(jp), traj), ranks, 1,
                 TOL if route == "k4_plain" else TOL_BF16_AFTER_SUM)
    for r in out:
        _check_jax(r["loss"], r["metrics"], r["grads"], jout)


# ---------------------------------------------------------------------------
# the train step over data ranks
# ---------------------------------------------------------------------------

def _train_spec(pww, meshes=((1, 1),), horizon=4, epochs=2):
    """The attn net at hidden 32 on 8 werewolf rooms of 6, through K4's plain
    route (its gradients are f32 sums)."""
    cfg = N.NetConfig(hidden=32, arch="attn")
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(pww),
                           N.action_space(pww), cfg, pww, device="cpu")
    return {"game": "werewolf", "seats": 6, "rooms": 8, "start_seed": 11, "gen_seed": 5,
            "net": {"hidden": 32, "arch": "attn"},
            "ppo": {"horizon": horizon, "epochs": epochs, "fused_net": True},
            "params": {k: v.numpy() for k, v in params.items()}, "meshes": list(meshes),
            "device": "cpu"}


@pytest.fixture()
def world_of_one():
    """A torch.distributed world of this process alone, destroyed after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("fused", [False, True], ids=["autograd", "k4_plain"])
def test_dp1_through_the_mesh_is_todays_train_step(pww, world_of_one, fused):
    spec = _train_spec(pww)
    spec["ppo"]["fused_net"] = fused
    cfg = parity.config_of(spec)
    mesh = M.make_mesh(1, device="cpu")
    assert dist.get_world_size() == 1 and mesh.coords == (0, 0) and mesh.backend == "gloo"
    runs = []
    for m in (None, mesh):
        params = N.params_from_numpy(spec["params"], device="cpu")
        opt = P.make_optimizer(params, cfg)
        state = parity.start_of(spec, "cpu")
        gen = torch.Generator().manual_seed(spec["gen_seed"])
        step = P.make_train_step(pww, cfg, m)
        metrics = []
        for _ in range(2):
            state, met = step(params, opt, state, gen)
            metrics.append({k: v for k, v in met.items() if not k.endswith("_ms")})
        runs.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = runs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(x, y) for x, y in zip(s0, s1))
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a), (a, b)


def test_replicate_and_psum_metrics_on_a_world_of_one(world_of_one):
    mesh = M.make_mesh(device="cpu")
    assert (mesh.data_size, mesh.model_size) == (1, 1)
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2)]}
    rep = M.replicate(mesh, tree)
    assert torch.equal(rep["a"], tree["a"]) and rep["a"].data_ptr() != tree["a"].data_ptr()
    assert torch.equal(rep["b"][0], tree["b"][0])
    assert M.psum_metrics({"loss": torch.tensor([1.5, 2.0]), "n": 3}, mesh) == {
        "loss": 3.5, "n": 3.0}


@pytest.fixture(scope="module")
def dp_runs(pww):
    """One world of 4: meshes of its first 1, 2 and 4 ranks each take the
    first unroll and the first update's gradient from the same start (the
    chip check's mode, chip_smoke.py multidevice_dp)."""
    spec = _train_spec(pww, meshes=((1, 1), (2, 1), (4, 1)), horizon=3, epochs=1)
    return run_ranks(parity.first_update, 4, spec, device="cpu")


@pytest.mark.parametrize("ranks", [2, 4])
def test_dp_first_unroll_and_update_equal_one_rank(dp_runs, ranks):
    """The rooms and actions after the first unroll exact; the summed
    gradients, loss and metrics (reward_per_step and episodes summed over
    the ranks) within 1e-4; the sampling margins only on the one-rank mesh."""
    one = dp_runs[0]["1x1"]
    key = f"{ranks}x1"
    assert all(key in r for r in dp_runs[:ranks]) and all(key not in r for r in dp_runs[ranks:])
    split = [r[key] for r in dp_runs[:ranks]]
    for i, f in enumerate(GameState._fields):
        np.testing.assert_array_equal(np.concatenate([r["state"][i] for r in split]),
                                      one["state"][i], err_msg=f)
    np.testing.assert_array_equal(np.concatenate([r["actions"] for r in split], 1),
                                  one["actions"])
    for r in split:
        assert abs(float(r["loss"]) - float(one["loss"])) <= TOL * abs(float(one["loss"]))
        for k, v in one["metrics"].items():
            assert abs(float(r["metrics"][k]) - float(v)) <= TOL * max(abs(float(v)), 1e-2), k
        for k, g in one["grads"].items():
            assert rel_err(r["grads"][k], g) < TOL, (k, rel_err(r["grads"][k], g))
        assert "margins" not in r
    acted = np.isfinite(one["margins"])
    assert acted.any() and (one["margins"][acted] >= 0).all()


def test_dp_replicas_end_bit_for_bit_equal(pww):
    """2 updates at dp = 2: both ranks apply the same summed gradients, so
    their parameters and Adam state end with the same bits, moved from the
    start (the chip check holds dp = 4 over NCCL to the same)."""
    spec = {**_train_spec(pww, horizon=3, epochs=1), "n": 2, "updates": 2}
    ranks = run_ranks(parity.dp_updates, 2, spec, device="cpu")
    assert [r["device"] for r in ranks] == ["cpu", "cpu"]
    for k, v in ranks[0]["params"].items():
        assert not np.array_equal(v, spec["params"][k]), k
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
        for s, x in ranks[0]["adam"][k].items():
            np.testing.assert_array_equal(ranks[1]["adam"][k][s], x, err_msg=f"{k} {s}")


# ---------------------------------------------------------------------------
# the dryrun, the curve and the launcher
# ---------------------------------------------------------------------------

TINY_CURVE = {"per_rank": 2, "horizon": 1, "roll_steps": 2, "epochs": 1, "train_steps": 1}


def _check_curve(curve, counts, global_batch):
    assert curve["devices"] == counts and curve["global_batch"] == global_batch
    for series in ("rollout", "train", "rollout_weak", "train_weak"):
        assert set(curve[series]) == set(map(str, counts)), series
        assert min(curve[series].values()) > 0, series
    for split in (curve["split"], curve["split_weak"]):
        for point in split.values():
            assert point["collectives"] > 0 and point["step_ms"] > 0
            assert point["collective_ms"] >= 0 and point["host_wait_ms"] >= 0


def test_dryrun_multichip_4_on_cpu(capsys):
    """A (2, 2) mesh until episodes finish, then the curve by the same ranks."""
    out = G.dryrun_multichip(4, device="cpu", scaling=TINY_CURVE)
    assert out["mesh"] == {"data": 2, "model": 2} and out["backend"] == "gloo"
    assert out["episodes"] > 0 and out["train_steps"] >= 5 and np.isfinite(out["loss"])
    assert out["devices"] == ["cpu"] * 4 and out["env_steps_per_s"] > 0
    _check_curve(out["scaling"], [1, 2, 4], 8)
    assert "dryrun_multichip ok" in capsys.readouterr().out


def test_scaling_curve_on_cpu():
    _check_curve(G._scaling_curve(2, device="cpu", **TINY_CURVE), [1, 2], 4)


def test_entry_runs_on_cpu(pww):
    fn, (state, params) = G.entry("cpu")
    state, logits, value = fn(state, params)
    assert logits.shape[0] == 256 and logits.dim() == 3 and value.shape == logits.shape[:2]
    assert int(state.t[0]) == 1


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    M.check_ranks_per_card(1, "nccl", "cuda")
    M.check_ranks_per_card(4, "gloo", "cuda")
    with pytest.raises(ValueError, match='backend="gloo"'):
        M.check_ranks_per_card(2, "nccl", "cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match='backend="gloo"'):
        M.rank_device("cuda", "nccl", 1)


def test_make_mesh_needs_a_world_for_several_ranks():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        M.make_mesh(2, device="cpu")
    assert M.initialize_multihost(None, 1, 0, device="cpu") == 1
    assert not dist.is_initialized()


def test_run_ranks_reports_a_failing_rank():
    spec = {"game": "werewolf", "rooms": 6, "seats": 6, "steps": 1, "device": "cpu"}
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="does not split evenly"):
        run_ranks(parity.engine_rollout, 4, spec, device="cpu")
    assert time.perf_counter() - t0 < 60


def test_run_ranks_stops_ranks_at_its_timeout():
    with pytest.raises(TimeoutError, match="gave no result"):
        run_ranks(time.sleep, 2, device="cpu", timeout=0.5)


def test_stop_fork_server_leaves_no_process():
    from multiprocessing import forkserver, resource_tracker

    assert run_ranks(time.sleep, 1, device="cpu") == [None]
    pids = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    assert None not in pids
    stop_fork_server()
    for pid in pids:  # exited and reaped
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
