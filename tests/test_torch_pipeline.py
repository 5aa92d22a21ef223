"""The port's pipelined (1-stale) PPO learner (train/pipeline.py) on the CPU:
run_pipelined equals, bit for bit, the hand-rolled loop in which traj_{k+1}
is collected under theta_k before the update that makes theta_{k+1} (the
JAX suite's test_pipeline_matches_reference_staleness_loop), differs from
the loop without staleness, and trains. On the CPU the two stages run in
order; the two CUDA streams are checked by chip_smoke.py against this
serial order.

The submesh form (run_pipelined_sharded) runs its actor and learner ranks
as processes of a gloo world (parallel.launch.run_ranks): 1 actor + 1
learner equals run_pipelined bit for bit over 2 rounds; 1 actor + 2
learners (each trajectory split over the learners, the update data
parallel) within 1e-4."""

import numpy as np
import pytest
import torch

from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.train.pipeline import make_pipeline, run_pipelined
from game_engine_tpu_torch.parallel import parity
from game_engine_tpu_torch.parallel.launch import run_ranks
from tests.test_torch_net import rel_err
from tests.test_torch_state import builtin_pair
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)

B, N_SEATS = 8, 6


def _setup(arch="attn", epochs=2, horizon=4):
    pw = builtin_pair("werewolf").port
    cfg = P.PPOConfig(horizon=horizon, epochs=epochs, net=N.NetConfig(hidden=32, arch=arch))
    params, opt = P.init_training(pw, cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_state(pw, B, N_SEATS, np.arange(B, dtype=np.uint32), device="cpu")
    return pw, cfg, params, opt, state


def _fresh(params, cfg):
    p = {k: v.detach().clone() for k, v in params.items()}
    return p, P.make_optimizer(p, cfg)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_pipeline_matches_reference_staleness_loop():
    pw, cfg, params0, _, state0 = _setup()
    pair = make_pipeline(pw, cfg)
    collect, update = pair

    # reference: the explicit 1-stale interleave, the actor on its own copy
    rp, ropt = _fresh(params0, cfg)
    actor = {k: v.detach().clone() for k, v in rp.items()}
    gen = torch.Generator().manual_seed(1)
    rs, traj, lobs = collect(actor, state0, gen)
    for _ in range(3):
        nxt = collect(actor, rs, gen)
        update(rp, ropt, traj, lobs)
        with torch.no_grad():
            for k, v in actor.items():
                v.copy_(rp[k])
        rs, traj, lobs = nxt

    pp, popt = _fresh(params0, cfg)
    ps, metrics = run_pipelined(pw, cfg, pp, popt, state0, torch.Generator().manual_seed(1), 3,
                                pipeline=pair, device="cpu")
    assert all(torch.equal(rp[k], pp[k]) for k in rp)
    assert _same(rs, ps)
    assert np.isfinite(float(metrics["loss"]))

    # without staleness (each trajectory under the newest params) it differs
    sp, sopt = _fresh(params0, cfg)
    gen = torch.Generator().manual_seed(1)
    ss, traj, lobs = collect(sp, state0, gen)
    for _ in range(3):
        update(sp, sopt, traj, lobs)
        ss, traj, lobs = collect(sp, ss, gen)
    assert not all(torch.equal(sp[k], pp[k]) for k in sp)


def test_pipeline_trains():
    """The loss is finite and the params move under the stale pipeline
    (attn, the architecture this lever exists for)."""
    pw, cfg, params, opt, state = _setup(epochs=1)
    before = {k: v.detach().clone() for k, v in params.items()}
    _, metrics = run_pipelined(pw, cfg, params, opt, state, torch.Generator().manual_seed(2),
                               4, device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    assert int(metrics["episodes"]) >= 0
    assert any(not torch.equal(params[k].detach(), before[k]) for k in before)


def test_run_pipelined_refuses_a_state_on_another_device():
    pw, cfg, params, opt, state = _setup()
    with pytest.raises(ValueError, match="run_pipelined on"):
        run_pipelined(pw, cfg, params, opt, state._replace(present=state.present.to("meta")),
                      torch.Generator(), 1, device="cpu")


def _sharded(actors: int, learners: int, rounds: int = 2):
    """run_pipelined_sharded's ranks and run_pipelined from the same start
    (the attn net through K4's plain route, whose gradients are f32 sums)."""
    pw, cfg, params, _, _ = _setup(epochs=1, horizon=3)
    spec = {"game": "werewolf", "seats": N_SEATS, "rooms": B, "start_seed": 0, "gen_seed": 1,
            "net": {"hidden": 32, "arch": "attn"},
            "ppo": {"horizon": cfg.horizon, "epochs": cfg.epochs, "fused_net": True},
            "params": {k: v.detach().numpy() for k, v in params.items()},
            "actors": actors, "learners": learners, "rounds": rounds, "device": "cpu"}
    cfg = parity.config_of(spec)
    out = run_ranks(parity.pipeline, actors + learners, spec, device="cpu")
    ref_params, ref_opt = _fresh(params, cfg)
    ref_state, ref_metrics = run_pipelined(pw, cfg, ref_params, ref_opt,
                                           parity.start_of(spec, "cpu"),
                                           torch.Generator().manual_seed(1), rounds,
                                           device="cpu")
    assert [r["role"] for r in out] == ["actor"] * actors + ["learner"] * learners
    state = [np.concatenate([r["state"][i] for r in out[:actors]])
             for i in range(len(ref_state))]
    return out[actors:], out, state, ref_params, ref_state, ref_metrics


def test_sharded_pipeline_1_actor_1_learner_equals_run_pipelined():
    learners, ranks, state, ref_params, ref_state, ref_metrics = _sharded(1, 1)
    for got, want in zip(state, ref_state):
        np.testing.assert_array_equal(got, want.numpy())
    for r in ranks:  # the learner made theta_2, the actor received it
        for k, p in ref_params.items():
            np.testing.assert_array_equal(r["params"][k], p.detach().numpy(), err_msg=k)
    for k, v in ref_metrics.items():
        np.testing.assert_array_equal(learners[0]["metrics"][k], v.numpy(), err_msg=k)


def test_sharded_pipeline_1_actor_2_learners_within_1e4():
    learners, ranks, state, ref_params, ref_state, ref_metrics = _sharded(1, 2)
    for r in ranks:
        for k, p in ref_params.items():
            assert rel_err(r["params"][k], p.detach().numpy()) < 1e-4, k
    for got, want in zip(state, ref_state):
        np.testing.assert_array_equal(got, want.numpy())
    for r in learners:
        for k in ("loss", "pg_loss", "v_loss", "entropy", "ratio_mean"):
            a, b = float(r["metrics"][k]), float(ref_metrics[k])
            assert abs(a - b) <= 1e-4 * max(abs(b), 1e-2), (k, a, b)
        assert int(r["metrics"]["episodes"]) == int(ref_metrics["episodes"])
