"""Train the tiny chat LM by self-distillation (see policies/chat_lm.py).

Counterpart of game_engine_tpu/train/chat_lm.py. The template composer
(server/chat.py) plays teacher over simulated oracle rooms; the transformer
learns context -> reply next-char prediction, by plain autograd over
``chat_lm.forward`` and torch.optim.Adam (0.9, 0.999, eps 1e-8), on the card
unless --device cpu.

    python -m game_engine_tpu_torch.train.chat_lm --steps 3000 \\
        --out docs/checkpoints/chat_lm.npz

Deterministic given --seed: the corpus and the batch draws are the JAX
trainer's (np.random.default_rng(seed)); the initial weights come from a
torch.Generator seeded with --seed, so they differ from JAX's. --lr-decay
follows optax.cosine_decay_schedule(lr, steps, alpha=0.1). The checkpoint
is the JAX module's .npz format, loadable by either package.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import time

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.policies import chat_lm as C


EVAL_PAIRS = 700  # held-out pairs _evaluate decodes, from seeds [seeds, seeds + 25)


def cosine_lr(lr: float, steps: int, t: int, alpha: float = 0.1) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) at update count t (the
    updates done before this one)."""
    frac = min(t, steps) / steps
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """optax.adam(lr)'s update: Adam with (0.9, 0.999), eps 1e-8 outside
    the square root."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(params: dict, opt: torch.optim.Adam, tok: torch.Tensor, mask: torch.Tensor,
               cfg: C.LMConfig, lr: float) -> torch.Tensor:
    """One update at learning rate `lr` -> the batch loss (before it)."""
    for g in opt.param_groups:
        g["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = C.loss_fn(params, tok, mask, cfg)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pairs", type=int, default=50000)
    ap.add_argument("--games", default="werewolf,two-truths-and-a-lie",
                    help="comma list of catalog games for the corpus "
                         "(per-game quota of --max-pairs)")
    ap.add_argument("--seeds", type=int, default=260,
                    help="rooms simulated per game for the corpus")
    ap.add_argument("--d-model", type=int, default=160)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=576)
    ap.add_argument("--out", default="chat_lm.npz")
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--lr-decay", action="store_true",
                    help="cosine-decay lr to lr/10 over --steps (the long "
                         "runs need it: constant 3e-4 plateaus ~0.14/char, "
                         "too hot for exact-match greedy decoding)")
    ap.add_argument("--eval-ckpt", default=None, metavar="CKPT_NPZ",
                    help="skip training: load this checkpoint and run only "
                         "the held-out evaluation block (metrics written "
                         "next to the checkpoint). --seeds MUST match the "
                         "training run's value — the eval rooms are seeds "
                         "[seeds, seeds+25), so a mismatch evaluates on "
                         "TRAINING rooms and reports memorization")
    args = ap.parse_args(argv)
    device = D.resolve("cpu" if args.cpu else args.device)

    if args.eval_ckpt:
        params, cfg = C.load(args.eval_ckpt, device)
        args.out = args.eval_ckpt
        return {"metrics": _evaluate(args, params, cfg)}

    # grounded=True etc.: the corpus carries field Q&A, personas, the v2
    # intents and the suspicion segments, so the checkpoint may serve them
    cfg = C.LMConfig(d_model=args.d_model, n_layers=args.layers,
                     max_len=args.max_len, grounded=True, personas=True,
                     kinds2=True, sus2=True)
    t0 = time.time()
    pairs = C.build_corpus(games=tuple(args.games.split(",")),
                           seeds=range(args.seeds), max_pairs=args.max_pairs)
    # drop pairs encode_pair would truncate (a clipped reply has no EOS)
    fit = [(c, r) for c, r in pairs if C.pair_fits(c, r, cfg)]
    if len(fit) < len(pairs):
        print(f"WARNING: dropped {len(pairs) - len(fit)} of {len(pairs)} "
              f"pairs that overflow max_len={cfg.max_len}")
    pairs = fit
    toks, masks = zip(*(C.encode_pair(c, r, cfg) for c, r in pairs))
    toks = np.stack(toks)
    masks = np.stack(masks)
    corpus_s = time.time() - t0
    print(f"corpus: {len(pairs)} pairs in {corpus_s:.1f}s "
          f"(mean reply {np.mean([len(r) for _, r in pairs]):.1f} chars)")

    params = C.init_params(torch.Generator().manual_seed(args.seed), cfg, device)
    for v in params.values():
        v.requires_grad_(True)
    opt = make_optimizer(params, args.lr)

    rng = np.random.default_rng(args.seed)
    n = len(toks)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(args.steps):
        idx = rng.integers(0, n, size=args.batch)
        lr = cosine_lr(args.lr, args.steps, step) if args.lr_decay else args.lr
        ts = time.time()
        loss = train_step(params, opt, torch.as_tensor(toks[idx], device=device),
                          torch.as_tensor(masks[idx], device=device), cfg, lr)
        losses.append(float(loss))  # a host sync: the step has finished
        step_s.append(time.time() - ts)
        if step % 200 == 0 or step == args.steps - 1:
            print(json.dumps({"step": step, "loss": round(losses[-1], 4),
                              "wall_s": round(time.time() - t0, 1)}))

    params = {k: v.detach() for k, v in params.items()}
    C.save(args.out, params, cfg)
    # smoke-decode two corpus contexts so the artifact is demonstrably live
    for ctx, ref in pairs[:2]:
        print("CTX ", ctx)
        print("LM  ", C.greedy_reply(params, cfg, ctx))
        print("REF ", ref)
    return {"losses": losses, "step_s": step_s, "corpus_pairs": len(pairs),
            "corpus_s": corpus_s, "metrics": _evaluate(args, params, cfg)}


def _evaluate(args, params, cfg) -> dict:
    """Held-out evaluation on UNSEEN seeds (rooms, rosters, senders): exact
    match against the teacher composer, grounded and v2 faithfulness, and
    name-copy faithfulness; written next to the checkpoint. The replies are
    decoded in one batch (chat_lm.greedy_replies), each equal to its own
    greedy_reply."""
    from game_engine_tpu_torch.server.chat import grounded_reply_ok

    eval_pairs = C.build_corpus(seeds=range(args.seeds, args.seeds + 25),
                                max_pairs=EVAL_PAIRS)
    outs = C.greedy_replies(params, cfg, [ctx for ctx, _ in eval_pairs])
    em = 0
    name_oblig = name_met = 0
    g_total = g_em = g_faithful = 0
    v2_total = v2_em = v2_faithful = 0
    by_kind: dict = {}  # kind -> [total, exact]

    def fold(s):
        # the tokenizer's encodable projection of a reply: what the student
        # could possibly emit
        return C.decode_tokens(C.encode_text(s))

    for (ctx, ref), out in zip(eval_pairs, outs):
        em += int(fold(out) == fold(ref))
        kind = ctx.split("|", 1)[0][2:]  # "K=<kind>|…"
        row = by_kind.setdefault(kind, [0, 0])
        row[0] += 1
        row[1] += int(fold(out) == fold(ref))
        gm = re.search(r"\|G=([^|;]*);([^|;]*);([^|;]*);(h|p)(s|o)", ctx)
        if gm:  # grounded field question
            g_total += 1
            g_em += int(fold(out) == fold(ref))
            g_faithful += int(grounded_reply_ok(fold(out), {
                "fname": gm.group(2), "val": gm.group(3) or None,
                "hidden": gm.group(4) == "h"}))
        vm = re.search(r"\|(Gd|Hn)=([^|]+)", ctx)
        if vm or "|Wt=" in ctx:  # v2 intent (rules/history/advice)
            v2_total += 1
            v2_em += int(fold(out) == fold(ref))
            v2_faithful += int(
                fold(vm.group(2)) in fold(out) if vm
                else fold(out) == fold(ref))
        m = re.search(r"\|Ns=([^|]*)", ctx)
        roster = [e.split(":", 1)[1] for e in m.group(1).split(",")
                  if ":" in e] if m else []
        for nm in roster:
            if len(nm) >= 3 and re.search(rf"\b{re.escape(nm)}\b", ref):
                name_oblig += 1
                name_met += int(re.search(rf"\b{re.escape(nm)}\b", out)
                                is not None)
    metrics = {
        "eval_seed_start": args.seeds,
        "eval_pairs": len(eval_pairs),
        "exact_match": round(em / max(1, len(eval_pairs)), 4),
        "name_copy_obligations": name_oblig,
        "name_copy_rate": round(name_met / max(1, name_oblig), 4),
        "grounded_pairs": g_total,
        "grounded_exact_match": round(g_em / max(1, g_total), 4),
        "grounded_faithful_rate": round(g_faithful / max(1, g_total), 4),
        "v2_pairs": v2_total,
        "v2_exact_match": round(v2_em / max(1, v2_total), 4),
        "v2_faithful_rate": round(v2_faithful / max(1, v2_total), 4),
        "by_kind_exact_match": {
            k: [n, round(e / max(1, n), 4)]
            for k, (n, e) in sorted(by_kind.items())},
    }
    print("HELD-OUT", json.dumps(metrics))
    with open(args.out.replace(".npz", "") + ".metrics.json", "w") as f:
        json.dump(metrics, f)
    print("saved", args.out)
    return metrics


if __name__ == "__main__":
    main()
