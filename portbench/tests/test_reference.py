"""The plain reference against the port's plain CPU path at a tiny size:
the engine exactly, the observation and masks exactly, the net, its PPO
loss and gradient within float rounding. (The port is imported here, by
the test, never by the reference.)"""

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import engine as RE
from portbench.reference import lower_game
from portbench.reference import policy as RP
from portbench.reference.state import init_state as ref_init

GAMES = {"werewolf8": "werewolf8.rollout", "two-truths8": "two-truths8.rollout"}
ROOMS, STEPS = 48, 96


def _port_lowered(path):
    import os

    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(load_game_spec(os.path.join(spec.ROOT, path))))


def _equal_states(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("config", sorted(GAMES))
def test_lowering_equals_the_ports(config):
    cfg = spec.cell(GAMES[config]).config
    ref, port = lower_game(cfg["game_file"]), _port_lowered(cfg["game_file"])
    assert (ref.P, ref.NP) == (port.P, port.NP)
    for name in ("phase_is_action", "phase_target_pred", "phase_static_next", "choice_kind",
                 "choice_max", "bool_defaults", "num_defaults", "str_defaults"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np.asarray(getattr(port, name)), err_msg=name)


@pytest.mark.parametrize("config", sorted(GAMES))
def test_rollout_equals_the_ports_plain_rollout(config):
    from game_engine_tpu_torch.core import engine as PE
    from game_engine_tpu_torch.core.state import init_state

    cfg = spec.cell(GAMES[config]).config
    ref_low, port_low = lower_game(cfg["game_file"]), _port_lowered(cfg["game_file"])
    seeds = np.random.default_rng(5).integers(0, 2 ** 32, ROOMS, dtype=np.uint32)
    a = ref_init(ref_low, ROOMS, 8, seeds, device="cpu")
    b = init_state(port_low, ROOMS, 8, seeds, device="cpu")
    _equal_states(a, b)
    a, ea = RE.make_rollout(ref_low, STEPS)(a)
    b, eb = PE.rollout(port_low, b, STEPS)
    _equal_states(a, b)
    assert int(ea) == int(eb)


def test_unroll_pieces_equal_the_ports_plain_pieces():
    from game_engine_tpu_torch.core import engine as PE
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N

    cfg = spec.cell("werewolf8.train").config
    ref_low, port_low = lower_game(cfg["game_file"]), _port_lowered(cfg["game_file"])
    seeds = np.arange(16, dtype=np.uint32)
    a = ref_init(ref_low, 16, 8, seeds, device="cpu")
    b = init_state(port_low, 16, 8, seeds, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(12):
        assert torch.equal(RP.observe_plain(ref_low, a), N.observe_plain(port_low, b))
        assert torch.equal(RP.legal_action_mask_plain(ref_low, a),
                           N.legal_action_mask_plain(port_low, b))
        mask = RP.actor_mask_plain(ref_low, a)
        assert torch.equal(mask, N.actor_mask_plain(port_low, b))
        acts = torch.randint(0, 9, (16, 8), generator=gen, dtype=torch.int32)
        a, ended, reward = RE.step_and_reset(ref_low, a, acts)
        nb = PE.step_and_reset(port_low, b, acts, rewards=True)
        b = nb.state
        _equal_states(a, b)
        assert torch.equal(ended, nb.ended) and torch.equal(reward, nb.reward)


def test_net_loss_and_gradient_equal_the_ports_plain_kernels():
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N

    cfg = spec.cell("werewolf8.train").config
    port_low = _port_lowered(cfg["game_file"])
    net = cfg["net"]
    d = FZ.dims_for(port_low, N.NetConfig(hidden=net["hidden"], layers=net["layers"],
                                          arch=net["arch"]))
    rd = RP.dims_for(lower_game(cfg["game_file"]), net["hidden"], net["layers"], net["arch"])
    gen = torch.Generator().manual_seed(11)
    params = {k: torch.randn(s, generator=gen) * 0.1 for k, s in RP.param_shapes(rd).items()}
    n = 64
    rows = torch.rand((n, rd.F), generator=gen).to(torch.bfloat16)
    lo, vo = FZ.fused_forward_plain(d, rows, params)
    lr, vr = RP.forward(rd, rows, params)
    torch.testing.assert_close(lr, lo, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vr, vo, rtol=1e-5, atol=1e-5)
    legal = torch.rand((n, rd.A), generator=gen) < 0.7
    legal[:, 0] = True
    actions = torch.randint(1, rd.A + 1, (n,), generator=gen)
    logp, adv, ret = (torch.randn(n, generator=gen) for _ in range(3))
    mask = torch.rand(n, generator=gen) < 0.6
    rowin_p = FZ._loss_rows(d, legal, actions, logp, adv, ret, mask, 0.5)
    rowin_r = RP.loss_rows(rd, legal, actions, logp, adv, ret, mask, 0.5)
    torch.testing.assert_close(rowin_r, rowin_p)
    gp, sp = FZ.loss_vg_plain(d, rows, rowin_p, params, 0.2, 0.01)
    gr, sr = RP.loss_vg(rd, rows, rowin_r, params, 0.2, 0.01)
    torch.testing.assert_close(sr, sp, rtol=1e-5, atol=1e-6)
    for k in gp:
        torch.testing.assert_close(gr[k], gp[k], rtol=1e-4, atol=1e-6)


def test_fp8_rounds_coarser_than_bf16():
    x = torch.tensor([1.0 + 2 ** -5, 3.3, -500.0])
    assert RP.rounding("bf16")(x)[0] == 1.0 + 2 ** -5
    assert RP.rounding("fp8")(x)[0] == 1.0
    assert RP.rounding("fp8")(x)[2] == -448.0
    with pytest.raises(ValueError):
        RP.rounding("fp16")


@pytest.mark.card
def test_reference_rollout_on_the_card_equals_the_kernel(card):
    from game_engine_tpu_torch.core import engine as PE
    from game_engine_tpu_torch.core.state import init_state

    cfg = spec.cell("werewolf8.rollout").config
    ref_low, port_low = lower_game(cfg["game_file"]), _port_lowered(cfg["game_file"])
    seeds = np.arange(1024, dtype=np.uint32)
    a, ea = RE.make_rollout(ref_low, 64)(ref_init(ref_low, 1024, 8, seeds, device=card))
    b, eb = PE.rollout(port_low, init_state(port_low, 1024, 8, seeds, device=card), 64)
    _equal_states(a, b)
    assert int(ea) == int(eb)
