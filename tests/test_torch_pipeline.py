"""The port's pipelined (1-stale) PPO learner (train/pipeline.py) on the CPU:
run_pipelined equals, bit for bit, the hand-rolled loop in which traj_{k+1}
is collected under theta_k before the update that makes theta_{k+1} (the
JAX suite's test_pipeline_matches_reference_staleness_loop), differs from
the loop without staleness, and trains. On the CPU the two stages run in
order; the two CUDA streams are checked by chip_smoke.py against this
serial order."""

import numpy as np
import pytest
import torch

from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.train.pipeline import make_pipeline, run_pipelined
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
