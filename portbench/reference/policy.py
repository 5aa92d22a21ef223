"""The plain policy net, its PPO loss and the observation it reads.

A frozen copy of the port's plain versions, kept here so that the
reference shares no code with the program: observe_plain,
legal_action_mask_plain and actor_mask_plain (policies/net.py), the net's
forward and the PPO loss with their gradient (policies/fused.py
fused_forward_plain and loss_vg_plain, the plain versions of K2 and K4,
with every cast point of the kernels), the kernel's per-row loss inputs
(fused._loss_rows, for one process) and GAE (train/ppo.py).

The one change: the cast points round to ``precision``, bf16 as the
configuration states, or float8 e4m3 for the control that a lower
precision must fail.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.gamespec.tables import Lowered
from portbench.reference.state import GameState, tables
from portbench.reference.step import PredEval, _alive

_F32 = torch.float32
_PRIVATE_RE = re.compile(r"\bprivate\b|\bhidden\b|\bsecret\b", re.IGNORECASE)
_REVEAL_RE = re.compile(r"reveal", re.IGNORECASE)

VIS_PUBLIC, VIS_SELF, VIS_TEAM = 0, 1, 2
FP8_MAX = 448.0  # the largest float8 e4m3 value


def rounding(precision: str):
    """x -> x rounded to `precision` and back to f32 ("bf16" or "fp8")."""
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(_F32)
    if precision == "fp8":
        return lambda x: x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(_F32)
    raise ValueError(f"unknown precision {precision!r}")


def bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).to(_F32)


def field_visibility(lowered: Lowered) -> dict[str, int]:
    """Per-field observation visibility, derived from the DSL itself.

    Fields whose declaration description says private/hidden/secret are
    SELF-only. The team field (and role) is TEAM when an audience group
    selects by team. Action bookkeeping is SELF when its phase selects its
    actors by non-public fields. Everything else is PUBLIC."""
    from portbench.reference.gamespec.expr import collect_atoms

    decl = lowered.game.spec.declaration
    team_grouped = any(
        re.search(r"\bteam\b", g.selection_criteria) for g in decl.audience_groups
    )
    out: dict[str, int] = {}
    for f in decl.fields:
        if _PRIVATE_RE.search(f.description) or _PRIVATE_RE.search(f.name):
            out[f.name] = VIS_SELF
        else:
            out[f.name] = VIS_PUBLIC
    base_vis = dict(out)
    if team_grouped:
        for name in ("team", "role"):
            if name in base_vis:
                base_vis[name] = VIS_TEAM

    for cp in lowered.game.phases:
        try:
            atoms = list(collect_atoms(cp.target_pred))
        except Exception:  # noqa: BLE001 — unknown pred shape: be private
            atoms = None
        if atoms is not None and all(
                base_vis.get(a.field, VIS_PUBLIC) == VIS_PUBLIC
                for a in atoms):
            continue  # selected by public info only: writes stay public
        rp = cp.program.record
        for name in rp.set_bool_true + rp.set_bool_false:
            out[name] = VIS_SELF
        for name in (rp.write_choice_num, rp.mark_odict):
            if name:
                out[name] = VIS_SELF
        if rp.write_pdict:
            out[rp.write_pdict[0]] = VIS_SELF
    if team_grouped:
        for name in ("team", "role"):
            if name in out:
                out[name] = VIS_TEAM
    return out


def _phase_public_acting(lowered: Lowered) -> np.ndarray:
    """(NP,) bool — whether WHO-has-acted in each phase is public info
    (the phase selects actors by public fields only)."""
    from portbench.reference.gamespec.expr import collect_atoms

    vis = field_visibility(lowered)
    out = np.zeros((lowered.NP,), dtype=bool)
    for cp in lowered.game.phases:
        try:
            atoms = list(collect_atoms(cp.target_pred))
        except Exception:  # noqa: BLE001
            atoms = None
        out[cp.index] = atoms is not None and all(
            vis.get(a.field, VIS_PUBLIC) == VIS_PUBLIC for a in atoms)
    return out


def minority_team_code(lowered: Lowered):
    """String code of the coordinating (minority/'evil') team, or None."""
    for m in lowered.game_overs:
        if m.mode == "team" and m.team_codes:
            return int(m.team_codes[0])
    return None


def _obs_fields(lowered: Lowered):
    """Declared fields that enter the observation ('name' is cosmetic)."""
    return [f for f in lowered.game.spec.declaration.fields if f.name != "name"]


def _per_player_dim(lowered: Lowered) -> int:
    lay = lowered.game.layout
    d = 2  # acted + alive
    for f in _obs_fields(lowered):
        s = lay.slot(f.name)
        if s.bank in ("bool", "num"):
            d += 1
        elif s.bank == "str":
            d += max(2, len(s.vocab))
    return d


def obs_dim(lowered: Lowered) -> int:
    P = lowered.P
    # full-room view + viewer one-hot + phase + count
    return P * _per_player_dim(lowered) + P + lowered.NP + 1


def action_space(lowered: Lowered) -> int:
    """Unified discrete choice space: 1..A (0 reserved for no-op)."""
    return max(lowered.P, int(lowered.choice_max.max()) if lowered.choice_max.size else 0)


def _phase_table(lowered: Lowered, name: str, fn, device) -> torch.Tensor:
    """A per-phase numpy table as a tensor, cached with the step's tables."""
    tabs = tables(lowered, device)
    if name not in tabs:
        tabs[name] = torch.as_tensor(fn(lowered), device=device)
    return tabs[name]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot; out-of-range indices give all zeros (as jax.nn.one_hot)."""
    return (idx[..., None].long() == torch.arange(n, device=idx.device)).to(dtype)


def observe_plain(lowered: Lowered, state: GameState, masked: bool = True) -> torch.Tensor:
    """observe's plain torch body."""
    B, P = state.present.shape
    dev = state.present.device
    lay = lowered.game.layout
    vis = field_visibility(lowered)
    team_slot = lay.get("team")
    if masked and team_slot is not None and team_slot.bank == "str":
        team = state.strs[..., team_slot.index]
        same_team = (team[:, :, None] == team[:, None, :]) & (team[:, :, None] != 0)
        # only the coordinating (minority) team sees its teammates
        code = minority_team_code(lowered)
        if code is not None:
            same_team = same_team & (team[:, :, None] == code)
    else:
        same_team = torch.zeros((B, P, P), dtype=torch.bool, device=dev)
    is_self = torch.eye(P, dtype=torch.bool, device=dev)[None].expand(B, P, P)

    # P15: a seat whose reveal flag is set has its role/team made public
    revealed = None
    if masked:
        for f in lowered.game.spec.declaration.fields:
            if _REVEAL_RE.search(f.name):
                rs = lay.get(f.name)
                if rs is not None and rs.bank == "bool":
                    revealed = state.bools[..., rs.index]  # (B, P) targets
                    break

    def mask_for(field: str) -> Optional[torch.Tensor]:
        """(B, viewer P, target P) — may the viewer see this field? None: all."""
        if not masked:
            return None
        v = vis.get(field, VIS_PUBLIC)
        if v == VIS_SELF:
            m = is_self
        elif v == VIS_TEAM:
            m = is_self | same_team
        else:
            return None
        if revealed is not None and field in ("role", "team"):
            m = m | revealed[:, None, :]
        return m

    dt = torch.bfloat16
    blocks = []
    for f in _obs_fields(lowered):
        s = lay.slot(f.name)
        if s.bank == "bool":
            feat = state.bools[..., s.index, None].to(dt)
        elif s.bank == "num":
            feat = state.nums[..., s.index, None].to(dt) / torch.tensor(P, dtype=dt)
        elif s.bank == "str":
            feat = _one_hot(state.strs[..., s.index], max(2, len(s.vocab)), dt)
        else:
            continue  # dict banks enter via their recorded scalar effects
        m = mask_for(f.name)
        full = feat[:, None, :, :].expand(B, P, P, feat.shape[-1])
        blocks.append(full if m is None else torch.where(m[..., None], full, 0))
    alive = _alive(lowered, state)
    acted = state.acted
    if masked:
        # who-acted is public only in publicly-targeted phases
        pub = _phase_table(lowered, "phase_public_acting", _phase_public_acting,
                           dev)[state.phase.long()]
        acted_vt = acted[:, None, :] & (pub[:, None, None] | is_self)
        blocks.append(acted_vt.to(dt)[..., None])
    else:
        blocks.append(acted.to(dt)[:, None, :, None].expand(B, P, P, 1))
    blocks.append(alive.to(dt)[:, None, :, None].expand(B, P, P, 1))
    room = torch.cat(blocks, dim=-1).reshape(B, P, -1)  # (B, V, T*F0)

    viewer = torch.eye(P, dtype=dt, device=dev)[None].expand(B, P, P)
    phase_oh = _one_hot(state.phase, lowered.NP, dt)[:, None, :].expand(B, P, lowered.NP)
    n_alive = (alive.sum(1, dtype=torch.int32).to(dt) / torch.tensor(P, dtype=dt))
    n_alive = n_alive[:, None, None].expand(B, P, 1)
    return torch.cat([room, viewer, phase_oh, n_alive], dim=-1)


def legal_action_mask_plain(lowered: Lowered, state: GameState) -> torch.Tensor:
    """legal_action_mask's plain torch body."""
    from portbench.reference.gamespec.mechanics import ChoiceKind

    B, P = state.present.shape
    dev = state.present.device
    A = action_space(lowered)
    tabs = tables(lowered, dev)
    phl = state.phase.long()
    kind = tabs["choice_kind"][phl][:, None, None]  # (B, 1, 1)
    kmax = tabs["choice_max"][phl][:, None, None]
    n_present = state.present.sum(1, dtype=torch.int32)[:, None, None]
    cidx = torch.arange(1, A + 1, dtype=torch.int32, device=dev)[None, None, :]
    alive_pad = F.pad(_alive(lowered, state), (0, max(0, A - P)))[:, None, :]
    target_ok = (cidx <= P) & alive_pad
    hi = torch.where(kmax > 0, kmax, n_present)
    option_ok = cidx <= hi
    submit_ok = cidx == 1
    mask = torch.where(
        kind == ChoiceKind.TARGET.value,
        target_ok,
        torch.where(kind == ChoiceKind.OPTION.value, option_ok, submit_ok),
    )
    return mask.expand(B, P, A)


def actor_mask_plain(lowered: Lowered, state: GameState) -> torch.Tensor:
    """actor_mask's plain torch body."""
    pe = PredEval(lowered, state)
    target = torch.zeros_like(state.present)
    by_pred: dict[int, list[int]] = {}
    for i, pi in enumerate(lowered.phase_target_pred):
        by_pred.setdefault(int(pi), []).append(i)
    for pi, phase_idxs in by_pred.items():
        hit = torch.zeros_like(state.done)
        for i in phase_idxs:
            hit = hit | (state.phase == i)
        target = torch.where(hit[:, None], pe.pred(pi), target)
    is_action = tables(lowered, state.present.device)["phase_is_action"][
        state.phase.long()][:, None] != 0
    return target & state.present & is_action & ~state.acted & ~state.done[:, None]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh gelu, as jax.nn.gelu (approximate=True)."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static shape config for one (lowered game, net config) pair."""

    P: int          # seats
    F0: int         # per-target feature width
    NP: int         # phase count (one-hot width in globals)
    hp: int         # encoder width
    hidden: int     # trunk width
    layers: int     # trunk depth
    n_opt: int      # option-head width
    A: int          # unified action width = max(P, n_opt)
    has_attn: bool

    @property
    def G(self) -> int:  # viewer one-hot + phase one-hot + alive fraction
        return self.P + self.NP + 1

    @property
    def F(self) -> int:
        return self.P * self.F0 + self.G

    @property
    def trunk_in(self) -> int:
        return 2 * self.hp + self.NP + 1


def dims_for(lowered: Lowered, hidden: int, layers: int, arch: str) -> Dims:
    n_opt = max(1, int(lowered.choice_max.max()))
    return Dims(P=lowered.P, F0=_per_player_dim(lowered), NP=lowered.NP,
                hp=max(32, hidden // 2), hidden=hidden, layers=layers,
                n_opt=n_opt, A=max(lowered.P, n_opt), has_attn=arch == "attn")


def param_shapes(d: Dims) -> dict[str, tuple]:
    """The net's parameters by name, in the kernels' order, with their shapes."""
    hp, H = d.hp, d.hidden
    names = ["w_phi0", "b_phi0", "w_phi1", "b_phi1"]
    if d.has_attn:
        names += ["ln_s", "ln_b", "w_qkv", "w_ao"]
    names += ["w_ptr"]
    for i in range(d.layers):
        names += [f"w{i}", f"b{i}"]
    names += ["w_pi", "b_pi", "w_v", "b_v"]
    shapes = {"w_phi0": (d.F0, hp), "b_phi0": (hp,), "w_phi1": (hp, hp), "b_phi1": (hp,),
              "ln_s": (hp,), "ln_b": (hp,), "w_qkv": (hp, 3 * hp), "w_ao": (hp, hp),
              "w_ptr": (H, hp), "w_pi": (H, d.n_opt), "b_pi": (d.n_opt,),
              "w_v": (H, 1), "b_v": (1,)}
    for i in range(d.layers):
        shapes[f"w{i}"] = (d.trunk_in if i == 0 else H, H)
        shapes[f"b{i}"] = (H,)
    return {n: shapes[n] for n in names}


def forward(d: Dims, rows: torch.Tensor, params: dict, precision: str = "bf16"):
    """The net's forward: rows (n, F) bf16 -> (logits (n, A), value (n,)),
    rounding to `precision` at the kernels' cast points. Differentiable in
    params, with f32 cotangents through every cast point (_bfs), as the
    kernels' backward carries them."""
    P, F0, hp = d.P, d.F0, d.hp
    rnd = rounding(precision)

    def _bfs(x):  # rounded in the forward; the gradient passes in f32
        return x + (rnd(x) - x).detach()

    def _bdot(x, w):
        return _bfs(x) @ _bfs(w)

    x = rows.to(_F32)
    n = x.shape[0]
    room = x[:, :P * F0].reshape(n, P, F0)
    z0 = _bdot(room, params["w_phi0"]) + params["b_phi0"]
    e = gelu(_bdot(gelu(z0), params["w_phi1"]) + params["b_phi1"])
    eb = _bfs(e)
    if d.has_attn:
        mu = eb.mean(-1, keepdim=True)
        var = (eb - mu).square().mean(-1, keepdim=True)
        hn = (eb - mu) * torch.rsqrt(var + 1e-5)
        hb = _bfs(hn * params["ln_s"] + params["ln_b"])
        qkv = _bdot(hb, params["w_qkv"])
        q, k, w = qkv[..., :hp], qkv[..., hp:2 * hp], qkv[..., 2 * hp:]
        att = torch.softmax(q @ k.transpose(-1, -2) * (1.0 / math.sqrt(hp)), dim=-1)
        o = _bfs(att) @ w
        phi = _bfs(e + _bdot(o, params["w_ao"]))
    else:
        phi = eb
    viewer = x[:, P * F0:P * F0 + P]
    t = torch.cat([phi.sum(1) * (1.0 / P), (viewer[:, :, None] * phi).sum(1),
                   x[:, P * F0 + P:]], dim=-1)
    for i in range(d.layers):
        t = gelu(_bdot(t, params[f"w{i}"]) + params[f"b{i}"])
    opt = _bdot(t, params["w_pi"]) + params["b_pi"]
    g = _bfs(_bdot(t, params["w_ptr"]))
    scores = _bfs(phi * g[:, None, :]).sum(-1)  # (n, P)
    logits = F.pad(opt, (0, d.A - d.n_opt)) + F.pad(scores, (0, d.A - P))
    value = (_bdot(t, params["w_v"]) + params["b_v"])[:, 0]
    return logits, value


def loss_vg(d: Dims, rows: torch.Tensor, rowin: torch.Tensor, params: dict,
            clip_eps: float, ent_coef: float, precision: str = "bf16"):
    """The PPO loss over `forward` from the per-row inputs (see loss_rows),
    and its parameter gradient by autograd -> (grads, stats [pg_loss,
    vf * v_loss, entropy, ratio_mean]), each a sum over these rows."""
    A = d.A
    with torch.enable_grad():
        leaves = {k: params[k].detach().to(_F32).requires_grad_(True)
                  for k in param_shapes(d)}
        logits, value = forward(d, rows, leaves, precision)
        legal, aoh = rowin[:, :A], rowin[:, A:2 * A]
        logp_old, advn, ret, wrow, vrow = rowin[:, 2 * A:].unbind(-1)
        logits = torch.where(legal > 0, logits, torch.full_like(logits, -1e9))
        logp_all = torch.log_softmax(logits, dim=-1)
        ratio = torch.exp((logp_all * aoh).sum(-1) - logp_old)
        pg = -torch.minimum(ratio * advn, ratio.clamp(1 - clip_eps, 1 + clip_eps) * advn)
        ent = -(logp_all.exp() * logp_all).sum(-1)
        stats = torch.stack([(pg * wrow).sum(), (0.5 * (value - ret) ** 2 * vrow).sum(),
                             (ent * wrow).sum(), (ratio * wrow).sum()])
        loss = stats[0] + stats[1] - ent_coef * stats[2]
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), stats.detach()


def loss_rows(d: Dims, legal, actions, logp_old, adv, ret, mask, vf_coef: float):
    """The loss's per-row inputs -> rowin (n, 2A + 5) f32 = legal | one-hot
    action | logp_old, normalised advantage, ret, wrow = mask / msum,
    vrow = vf_coef / n, over the whole batch of n rows."""
    n = mask.numel()
    A = d.A
    m = mask.to(_F32).reshape(n, 1)
    advf = adv.to(_F32).reshape(n, 1)
    msum, adv_sum = m.sum(), (advf * m).sum()
    msum = msum.clamp_min(1.0)
    mean = adv_sum / msum
    var_sum = (m * (advf - mean) ** 2).sum()
    std = torch.sqrt(var_sum / msum) + 1e-8
    a_idx = (actions.reshape(n).long() - 1).clamp(0, A - 1)
    aoh = F.one_hot(a_idx, A).to(_F32)
    return torch.cat([legal.reshape(n, A).to(_F32), aoh,
                      logp_old.to(_F32).reshape(n, 1), (advf - mean) / std,
                      ret.to(_F32).reshape(n, 1), m / msum,
                      torch.full((n, 1), vf_coef / n, dtype=_F32, device=m.device)],
                     dim=1).contiguous()


def gae(traj, last_value: torch.Tensor, gamma: float, lam: float):
    """(T, B, P) advantages + returns; bootstrap cut at episode ends."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = []
    for t in range(traj.value.shape[0] - 1, -1, -1):
        v, r = traj.value[t], traj.reward[t]
        nonterm = 1.0 - traj.done[t][:, None].to(torch.float32)
        delta = r + gamma * v_next * nonterm - v
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = v
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + traj.value
