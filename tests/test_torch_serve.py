"""The port's greedy policy bots (game_engine_tpu_torch/policies/serve.py)
against the JAX package's PolicyBots, on the shipped attn checkpoints:
legal logits within 2e-2 of the max |logit|, greedy actions equal wherever
the top two legal logits are more than 1e-3 apart (over 100 such seats),
ties to the lowest index, and a checkpoint that does not fit the game
skipped loudly. On the CPU the bots run K2's plain version."""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.policies import net as JN
from game_engine_tpu.policies.serve import PolicyBots as JaxPolicyBots
from game_engine_tpu.policies.serve import load_policy as jax_load_policy
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.policies import serve as S
from game_engine_tpu_torch.server.manager import GameHost
from tests.test_torch_net import host_state, jax_states, one_torch_thread  # noqa: F401
from tests.test_torch_state import builtin_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"werewolf": os.path.join(REPO, "docs", "checkpoints", "attn_werewolf_u120.npz"),
         "cult-of-the-depths": os.path.join(REPO, "docs", "checkpoints", "attn_cult_u120.npz")}


def _bots(game):
    pair = builtin_pair(game)
    jp, jcfg = jax_load_policy(CKPTS[game])
    tp, tcfg = N.load_policy(CKPTS[game], device="cpu")
    return pair, JaxPolicyBots(pair.jax, jp, jcfg, CKPTS[game]), S.PolicyBots(
        pair.port, tp, tcfg, CKPTS[game])


@pytest.mark.parametrize("game", sorted(CKPTS))
def test_greedy_matches_jax_policy_bots(game):
    pair, jb, pb = _bots(game)
    assert pb.route == "fused_plain"  # K2's plain version on CPU tensors
    assert pb.cfg == N.NetConfig(hidden=256, layers=2, arch="attn", attn_heads=1)
    launches = FZ.kernel_forward.launches
    checked = 0
    for jst in jax_states(pair.jax, B=8, n=min(6, pair.jax.P), steps=48, every=6, seed=3):
        st = host_state(jst)
        jlog, _ = JN.apply_net(jb.params, JN.observe(pair.jax, jst), jb.cfg, pair.jax)
        jmask = np.asarray(JN.legal_action_mask(pair.jax, jst))
        jlog = np.asarray(jnp.where(jmask, jlog, -1e9))
        logits, mask = pb.masked_logits(st)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        legal = np.where(jmask, jlog, 0.0)
        err = np.abs(np.where(jmask, logits.numpy(), 0.0) - legal).max()
        assert err <= 2e-2 * (np.abs(legal).max() + 1e-6)
        ja = jb.actions(jst)
        pa = pb.actions(st)
        assert pa.dtype == np.int32 and pa.shape == ja.shape
        top = np.sort(jlog, axis=-1)
        clear = ((top[..., -1] - top[..., -2]) > 1e-3) & np.asarray(jst.present)
        np.testing.assert_array_equal(pa[clear], ja[clear])
        no_choice = ~jmask.any(-1) | ~np.asarray(jst.present)
        assert (pa[no_choice] == 0).all() and (ja[no_choice] == 0).all()
        checked += int((clear & ~no_choice).sum())
    assert checked > 100
    assert FZ.kernel_forward.launches == launches  # no kernel on the CPU


def test_ties_resolve_to_the_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0], [-1e9, 5.0, -1e9, 5.0]])
    assert S.first_argmax(x).tolist() == [1, 0, 1]
    # a net whose every parameter is zero gives equal logits: each seat picks
    # its lowest legal choice, as the JAX bots do
    pair, jb, pb = _bots("werewolf")
    zp = {k: torch.zeros_like(v) for k, v in pb.params.items()}
    zb = S.PolicyBots(pair.port, zp, pb.cfg)
    jz = JaxPolicyBots(pair.jax, {k: jnp.zeros_like(v) for k, v in jb.params.items()}, jb.cfg)
    for jst in jax_states(pair.jax, B=4, n=6, steps=12, every=4, seed=9):
        st = host_state(jst)
        got = zb.actions(st)
        np.testing.assert_array_equal(got, jz.actions(jst))
        mask = N.legal_action_mask(pair.port, st).numpy()
        first = mask.argmax(-1) + 1
        want = np.where(mask.any(-1) & st.present.numpy(), first, 0)
        np.testing.assert_array_equal(got, want)


def test_forward_route_by_net_and_device():
    pair = builtin_pair("werewolf")
    attn = N.NetConfig(hidden=256, arch="attn")
    assert S.forward_route(pair.port, attn, "cpu") == "fused_plain"
    assert S.forward_route(pair.port, attn, "cuda") == "tensor_core"
    assert S.forward_route(pair.port, N.NetConfig(hidden=48, arch="attn"), "cuda") == "tensor_core"
    assert S.forward_route(pair.port, N.NetConfig(hidden=64, arch="mlp"), "cuda") == "apply_net"
    assert S.forward_route(pair.port, N.NetConfig(hidden=64, arch="attn", attn_heads=2),
                           "cpu") == "apply_net"
    # 40 seats, past a warp: K2 on the card and its plain version on the
    # CPU, as at 8; past the kernels' int32 parameter addressing, a raise on
    # the card naming the bound, not apply_net in K2's place, and apply_net
    # on the CPU, where no kernel runs
    big = builtin_pair("werewolf", {"max_players": 40}).port
    assert S.forward_route(big, attn, "cuda") == "tensor_core"
    huge = N.NetConfig(hidden=32768, arch="attn", layers=3)
    with pytest.raises(ValueError, match="MAX_PARAMS = 2147483647 parameters, not"):
        S.forward_route(big, huge, "cuda")
    assert S.forward_route(big, attn, "cpu") == "fused_plain"
    assert S.forward_route(big, huge, "cpu") == "apply_net"
    assert S.forward_route(big, N.NetConfig(hidden=64, arch="mlp"), "cuda") == "apply_net"


def test_mlp_policy_bots_run_apply_net():
    pair = builtin_pair("werewolf")
    cfg = N.NetConfig(hidden=32, arch="mlp")
    params = N.init_params(torch.Generator().manual_seed(1), N.obs_dim(pair.port),
                           N.action_space(pair.port), cfg, pair.port, device="cpu")
    pb = S.PolicyBots(pair.port, params, cfg)
    assert pb.route == "apply_net"
    pb.check_fits()
    st = host_state(jax_states(pair.jax, B=2, n=6, steps=6, every=6)[1])
    logits, mask = pb.masked_logits(st)
    want, _ = N.apply_net(params, N.observe(pair.port, st), cfg, pair.port)
    assert torch.equal(logits, torch.where(mask, want, torch.tensor(-1e9)))


def test_checkpoint_that_does_not_fit_is_skipped_loudly(caplog):
    """The werewolf checkpoint on cult-of-the-depths: its encoder input width
    differs, the host logs the mismatch and serves scripted bots."""
    host = GameHost(bot_ckpts=[f"cult={CKPTS['werewolf']}"], device="cpu")
    with caplog.at_level(logging.ERROR, logger="game_engine_tpu_torch.server.manager"):
        host.start_room("c", "cult-of-the-depths", 6, seed=2, human_seats=[1])
    assert host._policy_seats["c"] == ()
    assert host._policies["cult-of-the-depths#r1"] is None
    assert any("does not fit" in r.getMessage() for r in caplog.records)
    host2 = GameHost(bot_ckpts=[f"cult={CKPTS['cult-of-the-depths']}"], device="cpu")
    host2.start_room("c", "cult-of-the-depths", 6, seed=2, human_seats=[1])
    assert host2._policy_seats["c"] == (2, 3, 4, 5, 6)
    assert host2._policies["cult-of-the-depths#r1"].route == "fused_plain"


def test_load_bot_policies_parses_specs():
    out = S.load_bot_policies([f"Werewolf={CKPTS['werewolf']}", CKPTS["cult-of-the-depths"]],
                              device="cpu")
    assert sorted(out) == ["", "werewolf"]
    params, cfg, path = out["werewolf"]
    assert path == CKPTS["werewolf"] and cfg.arch == "attn"
    assert all(v.device.type == "cpu" for v in params.values())
