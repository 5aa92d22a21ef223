"""Traffic kind `train`: PPO self-play training steps, closed loop.

Set-up builds one learner, the program's `train_step` from
`ppo.make_train_step` with its parameters, Adam and rooms, from weights
and room seeds that the benchmark draws from --seed, and drives it
through its first `checked_steps` steps (its warm-up). The window hands
the same learner step after step; each ends in the program's own
synchronise (its CUDA-event spans). The window's work is rooms x horizon
env steps a step.

The check (portbench/reference/train.py, on the card after the window)
follows those first steps from the same weights, rooms and sampling
seed: every observation, mask, reward, end and state exactly; the
program's draws, log-probabilities and values; the first update's loss
terms, each step's loss; the first gradient as Adam got it (its first
moment after one update); and each parameter's change after the checked
steps (the median leaf's and the worst leaf's).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from portbench import harness
from portbench.harness import Check, Run, now
from portbench.yardstick import net_dims

BETA1 = 0.9  # torch.optim.Adam's default, which the program's optimizer keeps


def init_weights(d, seed: int, device) -> dict:
    """The net's f32 weights from `seed`, drawn on `device` in one call:
    normal / sqrt(fan_in) weights, zero biases, unit LayerNorm scale."""
    from portbench.reference.policy import param_shapes

    shapes = param_shapes(d)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(a * b for a, b in mats.values()), generator=gen,
                       dtype=torch.float32, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in mats:
            n = s[0] * s[1]
            out[k] = flat[at:at + n].view(s) / float(s[0]) ** 0.5
            at += n
        elif k == "ln_s":
            out[k] = torch.ones(s, dtype=torch.float32, device=device)
        else:
            out[k] = torch.zeros(s, dtype=torch.float32, device=device)
    return out


def _cpu(x):
    return x.detach().to("cpu", copy=True)


class Learner:
    """The program's learner as the window drives it, with the first steps'
    trajectories recorded on the host for the check."""

    def __init__(self, cell, seed: int, device):
        from game_engine_tpu_torch.core.state import init_state
        from game_engine_tpu_torch.gamespec.compile import compile_game
        from game_engine_tpu_torch.gamespec.parser import load_game_spec
        from game_engine_tpu_torch.gamespec.tables import lower
        from game_engine_tpu_torch.policies import net as N
        from game_engine_tpu_torch.train import ppo

        from portbench.spec import ROOT

        cfg, w = cell.config, cell.workload
        p, net = cfg["ppo"], cfg["net"]
        self.lowered = lower(compile_game(load_game_spec(os.path.join(ROOT, cfg["game_file"]))))
        self.pcfg = ppo.PPOConfig(
            horizon=p["horizon"], epochs=p["epochs"], gamma=p["gamma"], lam=p["lam"],
            clip=p["clip"], vf_coef=p["vf_coef"], ent_coef=p["ent_coef"], lr=p["lr"],
            fused_net=True, net=N.NetConfig(hidden=net["hidden"], layers=net["layers"],
                                             arch=net["arch"], attn_heads=net["attn_heads"]))
        self.params0 = init_weights(net_dims(cfg), harness.stream_seed(seed, 0), device)
        self.params = {k: v.clone() for k, v in self.params0.items()}
        self.opt = ppo.make_optimizer(self.params, self.pcfg)
        self.seeds = harness.room_seeds(seed, int(w["rooms"]))
        self.gen_seed = harness.stream_seed(seed, 1)
        self.generator = torch.Generator(device=device).manual_seed(self.gen_seed)
        self.state = init_state(self.lowered, int(w["rooms"]), cfg["seats"], self.seeds,
                                device=device)
        self.recording = True
        self.recorded, self.update_losses = [], []
        real_unroll, real_update = ppo.make_unroll, ppo.make_update

        def make_unroll(*args, **kwargs):  # the program's unroll, recorded while asked
            unroll = real_unroll(*args, **kwargs)

            def recorded_unroll(params, state, generator):
                out, traj = unroll(params, state, generator)
                if self.recording:
                    self.recorded.append(([_cpu(x) for x in traj], [_cpu(x) for x in out]))
                    self.update_losses.append([])
                return out, traj

            return recorded_unroll

        def make_update(*args, **kwargs):  # the program's update, each loss kept while asked
            update = real_update(*args, **kwargs)

            def recorded_update(params, opt, traj, adv, ret):
                loss, metrics = update(params, opt, traj, adv, ret)
                if self.recording:  # the loss and its terms as the reference's stats hold them
                    self.update_losses[-1].append(torch.stack([
                        loss, metrics["pg_loss"], metrics["v_loss"] * self.pcfg.vf_coef,
                        metrics["entropy"], metrics["ratio_mean"]]).detach().to(torch.float64))
                return loss, metrics

            return recorded_update

        ppo.make_unroll, ppo.make_update = make_unroll, make_update
        try:
            self.train_step = ppo.make_train_step(self.lowered, self.pcfg)
        finally:
            ppo.make_unroll, ppo.make_update = real_unroll, real_update

    def step(self):
        self.state, metrics = self.train_step(self.params, self.opt, self.state, self.generator)
        return metrics


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda") -> Run:
    w, cfg = cell.workload, cell.config
    rooms, H = int(w["rooms"]), cfg["ppo"]["horizon"]
    t_imports = now()
    ln = Learner(cell, seed, device)
    t_learner = now()
    start = [_cpu(x) for x in ln.state]
    first_moment = {}

    def after_first_update(opt, *_):
        for k, v in ln.params.items():
            first_moment[k] = _cpu(opt.state[v]["exp_avg"])
        hook.remove()

    hook = ln.opt.register_step_post_hook(after_first_update)
    step_s = []
    for _ in range(int(w["checked_steps"])):
        a = now()
        ln.step()
        step_s.append(now() - a)
    ln.recording = False
    recorded, ln.recorded = ln.recorded, []
    losses = [[float(x[0]) for x in step] for step in ln.update_losses]
    terms1 = [float(x) for x in ln.update_losses[0][0][1:]]
    params_after = {k: _cpu(v) for k, v in ln.params.items()}
    setup_s = now() - t0
    print(f"portbench: set-up: {t_imports - t0:.3f} s to the driver, learner "
          f"{t_learner - t_imports:.3f} s, checked steps {[round(x, 3) for x in step_s]} s",
          file=sys.stderr)

    traced, tracer, trace_from = {}, None, int(w["trace_after_steps"])
    spans = []
    t_start = now()
    while True:
        i = len(spans)
        if trace and i == trace_from:
            tracer = harness.Tracer().__enter__()
        m = ln.step()
        spans.append((m["unroll_ms"], m["update_ms"]))
        if tracer is not None and i + 1 == trace_from + int(w["trace_steps"]):
            tracer.__exit__(None, None, None)
            traced = {"steps": int(w["trace_steps"]), "spans": spans[trace_from:],
                      "rooms": rooms}
            done_tracer, tracer = tracer, None
        if now() - t_start >= seconds and (not trace or traced):
            break
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = now() - t_start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    params0 = {k: _cpu(v) for k, v in ln.params0.items()}
    del ln
    if device == "cuda":
        torch.cuda.empty_cache()
    program = {"start": start, "recorded": recorded, "losses": losses, "terms1": terms1,
               "grad1": {k: v / (1 - BETA1) for k, v in first_moment.items()},
               "params": params_after}
    t_check = now()
    checks = check(cell, seed, params0, program, device)
    check_s = now() - t_check
    return Run(setup_s=setup_s, window_s=window_s, work=len(spans) * rooms * H,
               attempted=len(spans), failed=0, memory_peak_bytes=peak, checks=checks,
               check_s=check_s, trace=done_tracer.trace if trace else None, traced=traced)


def teacher_of(traj: list, state: list):
    """A recorded program step in the reference's StepOut form (the
    program's Rollout holds these fields in this order)."""
    from portbench.reference.train import StepOut

    return StepOut(*traj, state=tuple(state), losses=[], grad1={})


def judge(cfg: dict, rooms: int, seed: int, params0: dict, program: dict, device) -> dict:
    """The reference follows the program's recorded steps -> the numbers."""
    from portbench.compare import leaf_norm_gaps, median, words_differing, worst
    from portbench.reference import lower_game
    from portbench.reference.state import GameState, init_state
    from portbench.reference.train import RefPPO, worse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lowered = lower_game(cfg["game_file"])
    d = net_dims(cfg)
    state = init_state(lowered, rooms, cfg["seats"], harness.room_seeds(seed, rooms),
                       device=device)
    words = words_differing(state, program["start"])
    ref = RefPPO(lowered, d, cfg["ppo"], params0, harness.stream_seed(seed, 1), device)
    num = {"draw_gap": 0.0, "value_gap": 0.0, "loss_gap": 0.0}
    logp_err, draws = 0.0, 0
    grad1 = None
    for s, (traj, out_state) in enumerate(program["recorded"]):
        teacher = teacher_of(traj, out_state)
        got, n = ref.step(state, teacher)
        state = GameState(*got.state)
        words += n["words"] + words_differing(state, out_state)
        for k in ("draw_gap", "value_gap"):
            num[k] = worse(num[k], n[k])
        logp_err, draws = logp_err + n["logp_err_sum"], draws + n["actor_draws"]
        gap = abs(program["losses"][s][-1] - got.losses[-1]) / got.scales[-1]
        num["loss_gap"] = worse(num["loss_gap"], gap)
        if grad1 is None:  # the first step's first epoch: both sides from the same weights
            grad1 = {k: v.cpu() for k, v in got.grad1.items()}
            # the value and entropy terms of its loss, each against its own size
            # (the policy term is 0 there by construction: advantages of mean 0, ratio 1)
            num["terms1_gap"] = max(abs(program["terms1"][i] - got.terms1[i])
                                    / max(abs(got.terms1[i]), 1e-30) for i in (1, 2))
    change_ref = {k: ref.params[k].detach().cpu() - params0[k] for k in params0}
    change_prog = {k: program["params"][k] - params0[k] for k in params0}
    g_norm = {k: float(v.double().norm()) for k, v in grad1.items()}
    med = sorted(g_norm.values())[len(g_norm) // 2]
    moved = [k for k, v in g_norm.items() if v >= 1e-3 * med]
    num["grad_gap"], num["worst_grad_leaf"] = worst(leaf_norm_gaps(program["grad1"], grad1))
    change = leaf_norm_gaps(change_prog, change_ref, moved)
    num["change_gap"] = median(change)
    num["change_gap_worst"], num["worst_change_leaf"] = worst(change)
    num["logp_err"] = logp_err / max(draws, 1)
    num["words_differing"] = words
    num["leaves_left_out"] = sorted(set(g_norm) - set(moved))
    num["leaves"] = leaf_readings(program["grad1"], grad1, change_prog, change_ref, change)
    num["grad_gap_own"] = max(v["own_grad_gap"] for v in num["leaves"].values())
    return num


def leaf_readings(g_prog: dict, g_ref: dict, c_prog: dict, c_ref: dict, change: dict) -> dict:
    """For each moved leaf, what says whether its change gap is the
    program's or the leaf's own noise: its first reference gradient's norm
    over the median leaf's, the gap of the first gradient's norms over its
    own norm, the share of its elements whose first gradient's sign the two
    sides disagree on, and the same share for the change."""
    def norm(x):
        return float(x.double().norm())

    def flips(a, b):
        nz = b != 0
        return float(((a.sign() != b.sign()) & nz).sum()) / max(int(nz.sum()), 1)

    g_prog = {k: g_prog.get(k, torch.zeros_like(v)) for k, v in g_ref.items()}  # none given: 0
    med = sorted(norm(v) for v in g_ref.values())[len(g_ref) // 2]
    return {k: {"g_over_median": norm(g_ref[k]) / med,
                "own_grad_gap": abs(norm(g_prog[k]) - norm(g_ref[k])) / max(norm(g_ref[k]), 1e-30),
                "grad_sign_flips": flips(g_prog[k], g_ref[k]),
                "change_sign_flips": flips(c_prog[k], c_ref[k]),
                "change_gap": change[k]} for k in change}


def check(cell, seed: int, params0: dict, program: dict, device) -> list:
    """The judge's numbers beside the cell's limits, the exact ones at 0;
    those that no limit can hold (the workload's `not_compared`) are only
    printed, with the leaves that set the norm gaps."""
    num = judge(cell.config, int(cell.workload["rooms"]), seed, params0, program, device)
    lim = cell.workload["limits"]
    info = {k: num[k] for k in cell.workload.get("not_compared", [])}
    info.update(worst_grad_leaf=num["worst_grad_leaf"], worst_change_leaf=num["worst_change_leaf"],
                leaves_left_out=num["leaves_left_out"],
                worst_change_leaf_readings=num["leaves"][num["worst_change_leaf"]])
    print(f"portbench: not compared {json.dumps(info)}", file=sys.stderr)
    return [Check("words_differing", num["words_differing"], 0)] + [
        Check(k, num[k], lim[k]) for k in lim]
