"""Learned bot policy: per-player actor-critic heads over room observations.

Counterpart of game_engine_tpu/policies/net.py with the same observation
layout, parameter names and shapes, and bf16 cast points:

  observe            (B, P, F) bf16, masked hidden-role view by default
  apply_net          mlp / deepsets / attn; bf16 operands, f32 accumulation,
                     tanh gelu
  legal_action_mask  (B, P, A) bool
  sample_actions     Gumbel-max over the legal-masked logits
  actor_mask         (B, P) bool, the seats whose decision this step counts
  observe_all        observe, legal_action_mask and actor_mask of one state
                     together

observe, legal_action_mask, actor_mask, observe_all and sample_actions take
CUDA tensors through the hand-written entries of csrc/observe.cu (OB for the
observation and masks, SA for the draw; policies/obs_kernel.py), one launch
each, and CPU tensors through the plain bodies (observe_plain,
legal_action_mask_plain, actor_mask_plain, sample_actions_plain), which they
equal bit for bit (logp within float rounding).

A product of bf16 operands is computed as f32 on the bf16-rounded values:
each product of two bf16 numbers is exact in f32 and the sum stays f32,
which is what ``_bf16_dot`` (bf16 operands, f32 accumulation) computes;
``torch.matmul`` on bf16 tensors would round its output to bf16.

``load_policy`` reads the JAX package's checkpoints (npz + .tree.json)
with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.core.state import GameState, tables
from game_engine_tpu_torch.core.step import PredEval, _alive

_PRIVATE_RE = re.compile(r"\bprivate\b|\bhidden\b|\bsecret\b", re.IGNORECASE)
_REVEAL_RE = re.compile(r"reveal", re.IGNORECASE)

VIS_PUBLIC, VIS_SELF, VIS_TEAM = 0, 1, 2


# ---------------------------------------------------------------------------
# numpy-level helpers (copied: the JAX module imports jax at its top)
# ---------------------------------------------------------------------------

def field_visibility(lowered: Lowered) -> dict[str, int]:
    """Per-field observation visibility, derived from the DSL itself.

    Fields whose declaration description says private/hidden/secret are
    SELF-only. The team field (and role) is TEAM when an audience group
    selects by team. Action bookkeeping is SELF when its phase selects its
    actors by non-public fields. Everything else is PUBLIC."""
    from game_engine_tpu_torch.gamespec.expr import collect_atoms

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
    from game_engine_tpu_torch.gamespec.expr import collect_atoms

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


# ---------------------------------------------------------------------------
# observation
# ---------------------------------------------------------------------------

def _phase_table(lowered: Lowered, name: str, fn, device) -> torch.Tensor:
    """A per-phase numpy table as a tensor, cached with the step's tables."""
    tabs = tables(lowered, device)
    if name not in tabs:
        tabs[name] = torch.as_tensor(fn(lowered), device=device)
    return tabs[name]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot; out-of-range indices give all zeros (as jax.nn.one_hot)."""
    return (idx[..., None].long() == torch.arange(n, device=idx.device)).to(dtype)


def _on_card(state: GameState) -> bool:
    return state.present.device.type == "cuda"


def observe(lowered: Lowered, state: GameState, masked: bool = True) -> torch.Tensor:
    """(B, P, F) bfloat16 — each viewer sees the room through the game's
    information rules (masked=True), or the full room (masked=False): OB on
    CUDA tensors, observe_plain on the CPU."""
    if _on_card(state):
        from game_engine_tpu_torch.policies import obs_kernel as OK

        return OK.kernel_observe(lowered, state, masked, legal=False, actor=False)[0]
    return observe_plain(lowered, state, masked)


def observe_all(lowered: Lowered, state: GameState, masked: bool = True, actor: bool = True):
    """(observe, legal_action_mask, actor_mask or None without
    `actor`) of one state: one OB launch on CUDA tensors, the plain
    functions on the CPU."""
    if _on_card(state):
        from game_engine_tpu_torch.policies import obs_kernel as OK

        return OK.kernel_observe(lowered, state, masked, actor=actor)
    return (observe_plain(lowered, state, masked), legal_action_mask_plain(lowered, state),
            actor_mask_plain(lowered, state) if actor else None)


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


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetConfig:
    hidden: int = 256
    layers: int = 2
    # 'mlp': flat trunk over the whole room observation; 'deepsets': a
    # shared per-seat encoder phi pooled over targets, with a pointer head
    # scoring each seat; 'attn': deepsets + one residual self-attention
    # block over the seat axis before pooling
    arch: str = "mlp"
    attn_heads: int = 1


def bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _BfSumOverData(torch.autograd.Function):
    """bf(w) forward. Backward: the f32 cotangent summed over the mesh's
    data group, then rounded to bf16 once, as one process rounds the whole
    batch's (JAX's GSPMD program sums before it rounds too). Data rank 0
    returns it and the others zero, since make_grad_fn sums every gradient
    over the data group once more after the backward."""

    @staticmethod
    def forward(ctx, w, mesh):
        ctx.mesh = mesh
        return bf(w)

    @staticmethod
    def backward(ctx, g):
        g = bf(ctx.mesh.data_sum(g.contiguous().clone()))
        return (g if ctx.mesh.data_index == 0 else torch.zeros_like(g)), None


def _weight(w: torch.Tensor, mesh=None) -> torch.Tensor:
    """A weight as a product's bf16 operand; over a data group of more than
    one rank its cotangent is rounded after the group's sum, not before."""
    if mesh is not None and mesh.data_size > 1:
        return _BfSumOverData.apply(w, mesh)
    return bf(w)


def _bf16_dot(x: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """bf16 operands, f32 accumulation: the rounded values multiplied in f32."""
    return bf(x) @ _weight(w, mesh)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh gelu, as jax.nn.gelu (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def init_params(generator: torch.Generator, in_dim: int, n_actions: int,
                cfg: NetConfig, lowered: Lowered | None = None,
                device=D.DEFAULT) -> dict[str, torch.Tensor]:
    """Plain-dict f32 params with the JAX package's names and shapes
    (normal / sqrt(fan_in) weights, zero biases), drawn from `generator`
    (a CPU generator), on `device`."""
    device = D.resolve(device)
    params: dict[str, torch.Tensor] = {}

    def lin(i, o):
        w = torch.randn((i, o), generator=generator, dtype=torch.float32)
        return (w / np.sqrt(i)).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    if cfg.arch in ("deepsets", "attn"):
        if lowered is None:
            raise ValueError("deepsets/attn init needs the lowered game")
        F0, NP = _per_player_dim(lowered), lowered.NP
        hp = max(32, cfg.hidden // 2)
        params["w_phi0"] = lin(F0, hp)
        params["b_phi0"] = zeros(hp)
        params["w_phi1"] = lin(hp, hp)
        params["b_phi1"] = zeros(hp)
        params["w_ptr"] = lin(cfg.hidden, hp)
        if cfg.arch == "attn":
            if hp % cfg.attn_heads != 0:
                raise ValueError(
                    f"attn arch needs max(32, hidden//2)={hp} divisible by "
                    f"attn_heads={cfg.attn_heads}")
            params["w_qkv"] = lin(hp, 3 * hp)
            params["w_ao"] = lin(hp, hp)
            params["ln_s"] = torch.ones((hp,), dtype=torch.float32, device=device)
            params["ln_b"] = zeros(hp)
        dims = [2 * hp + NP + 1] + [cfg.hidden] * cfg.layers
        n_actions = max(1, int(lowered.choice_max.max()))  # option head only
    else:
        dims = [in_dim] + [cfg.hidden] * cfg.layers
    for i in range(cfg.layers):
        params[f"w{i}"] = lin(dims[i], dims[i + 1])
        params[f"b{i}"] = zeros(dims[i + 1])
    params["w_pi"] = lin(cfg.hidden, n_actions)
    params["b_pi"] = zeros(n_actions)
    params["w_v"] = lin(cfg.hidden, 1)
    params["b_v"] = zeros(1)
    return params


def _trunk_and_heads(params, x, n_targets: int, ptr=None, mesh=None):
    """x bf16-valued f32 (..., in) -> (logits, value); ptr (..., P, hp)
    bf16-valued seat embeddings for the pointer head.

    With a mesh whose model axis is wider than 1, params holds this rank's
    trunk slices (parallel/mesh.py params_sharding): an even layer
    multiplies by its columns, an odd layer by its rows and sums the f32
    partial products over the model group before its bias and gelu, and
    after an odd layer count the last even layer's columns are gathered
    before the replicated heads (parallel/tp.py). The rounding points are
    the unsharded trunk's."""
    tp = mesh is not None and mesh.model_size > 1
    if tp:
        from game_engine_tpu_torch.parallel import tp as TP
    i = 0
    while f"w{i}" in params:
        if not tp:
            x = bf(gelu(_bf16_dot(x, params[f"w{i}"], mesh) + params[f"b{i}"]))
        elif i % 2 == 0:
            # the copy after the operand's bf16 cast, so the summed f32
            # cotangent is rounded to bf16 once, as in the unsharded trunk
            x = bf(gelu(TP.copy_to_model(bf(x), mesh) @ _weight(params[f"w{i}"], mesh)
                        + params[f"b{i}"]))
        else:
            x = bf(gelu(TP.reduce_from_model(_bf16_dot(x, params[f"w{i}"], mesh), mesh)
                        + params[f"b{i}"]))
        i += 1
    if tp and i % 2 == 1:
        x = TP.gather_from_model(x, mesh)
    logits = _bf16_dot(x, params["w_pi"], mesh) + params["b_pi"]
    if ptr is not None:
        # pointer scores for the first P actions: the product rounds to bf16
        # (the JAX net multiplies in bf16), the sum is f32
        g = bf(_bf16_dot(x, params["w_ptr"], mesh))
        scores = bf(ptr * g[..., None, :]).sum(-1)  # (..., P)
        a = max(n_targets, logits.shape[-1])
        logits = (F.pad(logits, (0, a - logits.shape[-1]))
                  + F.pad(scores, (0, a - scores.shape[-1])))
    value = (_bf16_dot(x, params["w_v"], mesh) + params["b_v"])[..., 0]
    return logits, value


def apply_net(params: dict[str, Any], obs: torch.Tensor, cfg: NetConfig,
              lowered: Lowered | None = None, mesh=None):
    """obs (..., F) -> (logits (..., A) f32, value (...,) f32). With a
    mesh of model axis > 1, the trunk is tensor-parallel over it (see
    _trunk_and_heads) and params holds this rank's slices."""
    x = bf(obs.float())
    if cfg.arch not in ("deepsets", "attn"):
        return _trunk_and_heads(params, x, obs.shape[-1], mesh=mesh)
    if lowered is None:
        raise ValueError("deepsets/attn apply needs the lowered game")
    P, F0 = lowered.P, _per_player_dim(lowered)
    lead = x.shape[:-1]
    room = x[..., : P * F0].reshape(lead + (P, F0))  # (..., target, F0)
    viewer_oh = x[..., P * F0: P * F0 + P]
    globals_ = x[..., P * F0 + P:]  # phase one-hot + n_alive
    phi = gelu(_bf16_dot(room, params["w_phi0"], mesh) + params["b_phi0"])
    phi = bf(gelu(_bf16_dot(phi, params["w_phi1"], mesh) + params["b_phi1"]))  # (..., P, hp)
    if cfg.arch == "attn":
        hp = phi.shape[-1]
        nh = cfg.attn_heads
        hd = hp // nh
        m = phi.mean(-1, keepdim=True)
        v = (phi - m).square().mean(-1, keepdim=True)
        h = bf((phi - m) * torch.rsqrt(v + 1e-5) * params["ln_s"] + params["ln_b"])
        qkv = _bf16_dot(h, params["w_qkv"], mesh).reshape(lead + (P, 3, nh, hd))
        q, k, w = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        att = torch.einsum("...qhd,...khd->...hqk", q, k) / np.sqrt(hd)
        att = bf(torch.softmax(att, dim=-1))
        o = torch.einsum("...hqk,...khd->...qhd", att, w).reshape(lead + (P, hp))
        phi = bf(phi + _bf16_dot(o, params["w_ao"], mesh))
    pooled = phi.mean(-2)
    self_phi = (phi * viewer_oh[..., None]).sum(-2)
    trunk_in = bf(torch.cat([pooled, self_phi, globals_], dim=-1))
    return _trunk_and_heads(params, trunk_in, P, ptr=phi, mesh=mesh)


# ---------------------------------------------------------------------------
# actions
# ---------------------------------------------------------------------------

def legal_action_mask(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P, A) bool — which choices the engine would accept (P2): OB on
    CUDA tensors, legal_action_mask_plain on the CPU."""
    if _on_card(state):
        from game_engine_tpu_torch.policies import obs_kernel as OK

        return OK.kernel_observe(lowered, state, obs=False, actor=False)[1]
    return legal_action_mask_plain(lowered, state)


def legal_action_mask_plain(lowered: Lowered, state: GameState) -> torch.Tensor:
    """legal_action_mask's plain torch body."""
    from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind

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


def actor_mask(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P) — players whose decision this step is policy-relevant: OB on
    CUDA tensors (one launch), actor_mask_plain on the CPU."""
    if _on_card(state):
        from game_engine_tpu_torch.policies import obs_kernel as OK

        return OK.kernel_observe(lowered, state, obs=False, legal=False)[2]
    return actor_mask_plain(lowered, state)


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


def uniforms(shape, generator: torch.Generator, device, rows=None) -> torch.Tensor:
    """torch.rand's f32 uniforms of `shape` from `generator`; with ``rows`` =
    (first, end, total), drawn for `total` leading rows and sliced to
    [first, end) (see sample_actions)."""
    if rows is None:
        return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    first, end, total = rows
    return torch.rand((total,) + tuple(shape[1:]), generator=generator, dtype=torch.float32,
                      device=device)[first:end]


def gumbel_noise(shape, generator: torch.Generator, device, rows=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [tiny, 1)."""
    u = uniforms(shape, generator, device, rows)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_actions(lowered: Lowered, params, state: GameState, cfg: NetConfig,
                   obs=None, apply_fn=None, gumbel=None,
                   generator: torch.Generator | None = None, rows=None, legal=None,
                   actor=None):
    """sample_actions_plain's draw (see there): on CUDA tensors the
    observation and legal mask come from OB where not given and the draw is
    SA, one launch on the logits and torch.rand's uniforms (the same stream
    the plain path turns into Gumbel noise) or the given ``gumbel``. With
    ``actor`` (B, P) bool, the actions returned are where(actor, actions,
    0), written by the same launch."""
    if not _on_card(state):
        a, logp, value, mask = sample_actions_plain(lowered, params, state, cfg, obs, apply_fn,
                                                    gumbel, generator, rows, legal)
        return (a if actor is None else torch.where(actor, a, 0)), logp, value, mask
    from game_engine_tpu_torch.policies import obs_kernel as OK

    if obs is None or legal is None:
        o, m, _ = OK.kernel_observe(lowered, state, obs=obs is None, legal=legal is None,
                                    actor=False)
        obs, legal = (o if obs is None else obs), (m if legal is None else legal)
    if apply_fn is None:
        logits, value = apply_net(params, obs, cfg, lowered)
    else:
        logits, value = apply_fn(params, obs)
    if gumbel is None:
        if generator is None:
            raise ValueError("sample_actions needs gumbel noise or a generator")
        noise, mode = uniforms(logits.shape, generator, logits.device, rows), "uniform"
    else:
        noise, mode = gumbel, "gumbel"
    a, masked, logp = OK.kernel_sample(logits, legal, noise, actor, mode)
    return (a if actor is None else masked), logp, value, legal


def sample_actions_plain(lowered: Lowered, params, state: GameState, cfg: NetConfig,
                         obs=None, apply_fn=None, gumbel=None,
                         generator: torch.Generator | None = None, rows=None, legal=None):
    """Sample per-player choices: argmax(masked logits + Gumbel noise), which
    is how jax.random.categorical draws.

    Returns (actions (B,P) 1-based int32, logp (B,P), value (B,P),
    legal-action mask (B,P,A)). ``gumbel`` supplies the noise (e.g. JAX's
    own draws in a test); otherwise it is drawn from ``generator``.
    ``apply_fn`` overrides the net forward (e.g. the fused kernel).
    ``rows`` = (first, end, total) says that these B rooms are rows
    [first, end) of a batch of `total` split over ranks: the noise is
    drawn for the whole batch and this rank keeps its rows, so every split
    samples what one process over the whole batch samples (every rank's
    generator is seeded alike). ``legal`` is the state's legal mask where
    the caller has it."""
    if obs is None:
        obs = observe_plain(lowered, state)
    if apply_fn is None:
        logits, value = apply_net(params, obs, cfg, lowered)
    else:
        logits, value = apply_fn(params, obs)
    mask = legal_action_mask_plain(lowered, state) if legal is None else legal
    if gumbel is None:
        if generator is None:
            raise ValueError("sample_actions needs gumbel noise or a generator")
        gumbel = gumbel_noise(logits.shape, generator, logits.device, rows)
    a, logp = draw_plain(logits, mask, gumbel)
    return a, logp, value, mask


def draw_plain(logits: torch.Tensor, legal: torch.Tensor, gumbel: torch.Tensor):
    """The plain draw of sample_actions_plain (SA's plain version): (1-based
    int32 argmax of the legal-masked logits plus the Gumbel noise, the
    log-softmax of the masked logits there)."""
    logits = torch.where(legal, logits, -1e9)  # a scalar: no copy to the card
    a = torch.argmax(logits + gumbel, dim=-1)  # (B, P) in [0, A)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, a[..., None])[..., 0]
    return (a + 1).to(torch.int32), logp


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def params_from_numpy(arrays: dict[str, np.ndarray],
                      device=D.DEFAULT) -> dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`."""
    device = D.resolve(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in arrays.items()}


def infer_net_config(params: dict[str, Any]) -> NetConfig:
    """The NetConfig from parameter shapes (as policies/serve.py infers it):
    attn carries w_qkv, deepsets w_phi0 without it, the flat MLP neither."""
    if "w_qkv" in params:
        arch = "attn"
    elif "w_phi0" in params:
        arch = "deepsets"
    else:
        arch = "mlp"
    hidden = int(params["w0"].shape[1])
    layers = 0
    while f"w{layers}" in params:
        layers += 1
    return NetConfig(hidden=hidden, layers=layers, arch=arch, attn_heads=1)


def load_policy(path: str, device=D.DEFAULT) -> tuple[dict[str, torch.Tensor], NetConfig]:
    """Load a save_tree checkpoint (npz + .tree.json) with numpy alone.
    Leaf i is the i-th key of the sorted params dict, as the treedef
    string lists it; the attn head count rides in the sidecar's meta."""
    stem = path[:-4] if path.endswith(".npz") else path
    with open(stem + ".tree.json", encoding="utf-8") as f:
        meta = json.load(f)
    with np.load(stem + ".npz") as npz:
        leaves = [npz[k] for k in
                  sorted(npz.files, key=lambda s: int(s.rsplit("_", 1)[1]))]
    keys = re.findall(r"'([^']+)': \*", meta["treedef"])
    if len(keys) != len(leaves):
        raise ValueError(f"checkpoint {path}: {len(leaves)} leaves vs {len(keys)} keys")
    params = params_from_numpy(dict(zip(keys, leaves)), device)
    cfg = infer_net_config(params)
    heads = int((meta.get("meta") or {}).get("attn_heads", 0))
    if heads:
        cfg = dataclasses.replace(cfg, attn_heads=heads)
    return params, cfg


def save_policy(path: str, params: dict[str, torch.Tensor], meta: dict | None = None) -> None:
    """Write params in the JAX package's save_tree layout: leaf_i arrays in
    sorted-key order in an npz, and the treedef string in .tree.json, so
    either package's loader reads it."""
    stem = path[:-4] if path.endswith(".npz") else path
    keys = sorted(params)
    np.savez_compressed(stem + ".npz", **{
        f"leaf_{i}": params[k].detach().cpu().numpy() for i, k in enumerate(keys)})
    treedef = "PyTreeDef({" + ", ".join(f"'{k}': *" for k in keys) + "})"
    with open(stem + ".tree.json", "w", encoding="utf-8") as f:
        json.dump({"treedef": treedef, "n": len(keys), **({"meta": meta} if meta else {})}, f)

