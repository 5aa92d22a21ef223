"""The reference's PPO step: the unroll with the plain engine, the plain
observation and the plain net, GAE, and each epoch's loss and gradient
with torch.optim.Adam, as train/ppo.py's train_step composes them.

``RefPPO.step`` plays a step on its own (the control, or a planted fault,
put in the program's place), or follows the program's step (``teacher``):
it then works out every step from its own state and parameters, takes the
program's actions only to step its engine after judging them, and
returns the numbers that compare the two.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import policy as RP
from portbench.reference.engine import step_and_reset

LOSS_BLOCK_ROWS = 131072  # rows a block of the reference's loss and gradient


@dataclasses.dataclass
class StepOut:
    """What a PPO step produced: the trajectory (T, B, P[, ...]), the state
    it ends in, each epoch's loss and the size of its terms, and the first
    epoch's gradient."""

    obs: torch.Tensor
    actions: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mask: torch.Tensor
    legal: torch.Tensor
    state: tuple
    losses: list
    grad1: dict
    scales: list = dataclasses.field(default_factory=list)  # each epoch's |terms| summed
    terms1: list = dataclasses.field(default_factory=list)  # the first epoch's [pg, vf * v, ent, ratio]


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from torch.rand's uniforms, as the plain draw."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class RefPPO:
    """A PPO learner from given weights and a sampling seed."""

    def __init__(self, lowered, d, ppo: dict, params0: dict, gen_seed: int, device,
                 precision: str = "bf16", fault: str | None = None):
        self.lowered, self.d, self.ppo, self.device = lowered, d, ppo, torch.device(device)
        self.precision, self.fault = precision, fault
        self.params = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                       for k, v in params0.items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=ppo["lr"])
        self.gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        self.steps = 0

    def _forward(self, obs: torch.Tensor):
        B, P, F = obs.shape
        with torch.no_grad():
            logits, value = RP.forward(self.d, obs.reshape(B * P, F), self.params, self.precision)
        return logits.reshape(B, P, -1), value.reshape(B, P)

    def step(self, state, teacher: StepOut | None = None):
        """One PPO step -> (StepOut, numbers). With a teacher, numbers holds
        what the comparison reads, else it is empty."""
        lw, d = self.lowered, self.d
        H = self.ppo["horizon"]
        num = {"words": 0, "draw_gap": 0.0, "value_gap": 0.0, "logp_err_sum": 0.0,
               "actor_draws": 0}
        xs = {k: [] for k in ("obs", "actions", "logp", "value", "reward", "done", "mask", "legal")}
        for t in range(H):
            obs = RP.observe_plain(lw, state)
            legal = RP.legal_action_mask_plain(lw, state)
            mask = RP.actor_mask_plain(lw, state)
            logits, value = self._forward(obs)
            u = torch.rand(logits.shape, generator=self.gen, dtype=torch.float32,
                           device=self.device)
            ml = torch.where(legal, logits, -1e9)
            score = ml + gumbel(u)
            own = torch.argmax(score, dim=-1)  # 0-based
            if teacher is None:
                chosen = own
                if self.fault == "altered" and self.steps == 0:  # room 0's draws, first step
                    chosen = _alter_room(chosen, legal, mask, 0)
                actions = torch.where(mask, chosen + 1, 0).to(torch.int32)
            else:
                dev = self.device
                num["words"] += sum(_differ(a, teacher_x[t].to(dev)) for a, teacher_x in (
                    (obs, teacher.obs), (legal, teacher.legal), (mask, teacher.mask)))
                actions = teacher.actions[t].to(dev)
                chosen = torch.where(mask, actions.long() - 1, own).clamp(0, d.A - 1)
                best = score.max(-1).values
                got = score.gather(-1, chosen[..., None])[..., 0]
                num["draw_gap"] = worse(num["draw_gap"], _max_at(best - got, mask))
            logp = torch.log_softmax(ml, dim=-1).gather(-1, chosen[..., None])[..., 0]
            if teacher is not None:
                err = (logp - teacher.logp[t].to(self.device)).abs()[mask]
                num["logp_err_sum"] += float(err.double().sum())
                num["actor_draws"] += int(err.numel())
                num["value_gap"] = worse(num["value_gap"], float(
                    (value - teacher.value[t].to(self.device)).abs().max()))
            state, ended, reward = step_and_reset(lw, state, actions)
            if teacher is not None:
                num["words"] += _differ(reward, teacher.reward[t].to(self.device))
                num["words"] += _differ(ended, teacher.done[t].to(self.device))
            for k, v in (("obs", obs), ("actions", actions), ("logp", logp), ("value", value),
                         ("reward", reward), ("done", ended), ("mask", mask), ("legal", legal)):
                xs[k].append(v)
        traj = {k: torch.stack(v) for k, v in xs.items()}
        _, last_v = self._forward(RP.observe_plain(lw, state))
        losses, scales, grad1, terms1 = self._update(traj, last_v)
        self.steps += 1
        out = StepOut(**traj, state=tuple(state), losses=losses, grad1=grad1, scales=scales,
                      terms1=terms1)
        return out, (num if teacher is not None else {})

    def _update(self, traj: dict, last_v: torch.Tensor):
        p, d = self.ppo, self.d

        class _T:  # what gae reads
            value, reward, done = traj["value"], traj["reward"], traj["done"]

        adv, ret = RP.gae(_T, last_v, p["gamma"], p["lam"])
        obs, legal, actions, logp, mask = (traj[k] for k in ("obs", "legal", "actions", "logp", "mask"))
        if self.fault == "half":  # half of the rooms left out, the mean over the rest
            half = obs.shape[1] // 2
            obs, legal, actions, logp, mask, adv, ret = (
                x[:, :half] for x in (obs, legal, actions, logp, mask, adv, ret))
        rows = obs.reshape(-1, d.F)
        rowin = RP.loss_rows(d, legal, actions, logp, adv, ret, mask, p["vf_coef"])
        losses, scales, grad1, terms1 = [], [], None, None
        for _ in range(p["epochs"]):
            grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
            stats = torch.zeros(4, dtype=torch.float64, device=self.device)
            for a in range(0, rows.shape[0], LOSS_BLOCK_ROWS):
                g, s = RP.loss_vg(d, rows[a:a + LOSS_BLOCK_ROWS], rowin[a:a + LOSS_BLOCK_ROWS],
                                  self.params, p["clip"], p["ent_coef"], self.precision)
                for k in grads:
                    grads[k] += g[k]
                stats += s.double()
            losses.append(float(stats[0] + stats[1] - p["ent_coef"] * stats[2]))
            scales.append(float(stats[0].abs() + stats[1].abs() + p["ent_coef"] * stats[2].abs()))
            if grad1 is None:
                grad1 = {k: v.detach().clone() for k, v in grads.items()}
                terms1 = [float(x) for x in stats]
            for k, v in self.params.items():
                v.grad = grads[k]
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        return losses, scales, grad1, terms1


def worse(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is."""
    return b if (b != b or b > a) else a


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.to(torch.float64) != b.to(torch.float64)).sum())


def _max_at(x: torch.Tensor, where: torch.Tensor) -> float:
    """max of x where `where` holds (0 where it never does); NaN stays NaN."""
    sel = x[where]
    if sel.numel() == 0:
        return 0.0
    if torch.isnan(sel).any():
        return math.nan
    return float(sel.max())


def _alter_room(chosen: torch.Tensor, legal: torch.Tensor, mask: torch.Tensor,
                room: int) -> torch.Tensor:
    """Each actor's choice in `room` moved to the next legal choice."""
    out = chosen.clone()
    for p in mask[room].nonzero()[:, 0].tolist():
        ok = legal[room, p].nonzero()[:, 0].tolist()
        if len(ok) > 1:
            out[room, p] = ok[(ok.index(int(chosen[room, p])) + 1) % len(ok)]
    return out
