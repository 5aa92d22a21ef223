"""Independent chat evaluation: hand-authored probes, host-verified.

Counterpart of game_engine_tpu/utils/eval_chat_probes.py: the same probes,
checks, tiers and output keys, with the port's chat LM hook on --device (the
decode kernel on the card, the default; its plain version on the CPU).

VERDICT r4 weak-item 3 / directive 5: every prior chat metric scored the
student against the template composer's own replies (string EM on a
corpus by the same author) — bounding distillation fidelity, not
conversational quality. This harness scores GROUNDED ACCURACY against the
live room state instead, on the frozen hand-authored probe set
(tests/fixtures/chat_probes.json): paraphrases outside the composer's
keyword vocabulary, adversarial pressure lines, and hidden-information
leak scans — the reference ChatBotNode's contract
(reference: agent/game_agent_v2.py:351-466: answer from the full game
context; never leak other players' secrets).

Checks (host-verifiable, composer-independent):
  grounded_value — the system grounded a visible field fact and the final
      reply names the field and quotes the exact live value
      (server/chat.py grounded_reply_ok);
  refusal       — the true hidden value does not appear; strict also
      requires the plan to classify the question as a hidden-field probe;
  no_leak       — the bot's own hidden values are not self-asserted
      ("I am a Werewolf" / "my team is ...") — accusation mentions of the
      same word are NOT leaks;
  dead_recap    — with dead players on the board, at least one is named.

Tiers (same probes, same rooms):
  composer       template composer only (lm_hook=None)
  student        shipped checkpoint, greedy (docs/checkpoints/chat_lm.npz)
  student_fb     the PRODUCT path: student + host verification + template
                 fallback (commit_reply semantics)
  sampled_fb     roleplay tier (temperature>0 on smalltalk kinds) + fallback

Usage:
    python -m game_engine_tpu_torch.utils.eval_chat_probes \
        [--out probes.json] [--no-lm] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                       "fixtures", "chat_probes.json")
_CKPT = os.path.join(os.path.dirname(__file__), "..", "..", "docs",
                     "checkpoints", "chat_lm.npz")


def build_room_snapshot(game: str, n_players: int, seed: int, steps: int):
    """Simulate a room to a mid-game point; return (snapshot, visibility,
    spec, oracle_room) in the shapes server/manager.py hands ChatRoom."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import games_dir, load_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.oracle.interp import OracleRoom
    from game_engine_tpu_torch.policies.net import field_visibility
    from game_engine_tpu_torch.policies.scripted import oracle_policy

    spec = load_game_spec(os.path.join(games_dir(), game + ".yaml"))
    lowered = lower(compile_game(spec))
    room = OracleRoom(lowered.game, n_players=n_players, seed=seed)
    for t in range(steps):
        if room.done:
            break
        room.step(oracle_policy(room, t, seed))
    dead = [str(p) for p, row in room.players.items()
            if not row.get("is_alive", True)]
    snapshot = {
        "player_states": {str(p): dict(row)
                          for p, row in room.players.items()},
        "current_phase_name": room.phase.name,
        "deadPlayers": dead,
    }
    return snapshot, dict(field_visibility(lowered)), spec, room


_SELF_ASSERT = (
    r"\b(?:i\s*am|i'm|im|my\s+role\s+is|my\s+team\s+is|as)\s+"
    r"(?:a\s+|an\s+|the\s+)?{val}\b")


def _leaks_self_value(reply: str, val: str) -> bool:
    """True when the reply SELF-ASSERTS the hidden value (accusing someone
    else of being that value is not a leak of one's own)."""
    if not val:
        return False
    low = reply.lower()
    v = re.escape(str(val).lower())
    if re.search(_SELF_ASSERT.format(val=v), low):
        return True
    # numeric hidden values: the bare number appearing at all is a leak
    if str(val).isdigit() and re.search(rf"\b{v}\b", low):
        return True
    return False


def run_probe(probe: dict, rooms: dict, lm_hook=None) -> dict:
    from game_engine_tpu_torch.server.chat import (ChatRoom, grounded_reply_ok,
                                             lm_may_serve)

    snapshot, visibility, _spec, _oracle = rooms[probe["game"]]
    chat = ChatRoom("probe-" + probe["id"], seed=11, lm_hook=lm_hook,
                    visibility=visibility)
    chat.post(1, "Vera", probe["q"])
    plan = chat.plan_reply(1, "Vera", probe["q"], snapshot)
    res = {"id": probe["id"], "ok": False, "served_by": "none"}
    if plan is None:
        res["error"] = "no bot replied"
        return res
    lm_text = None
    if lm_hook is not None and lm_may_serve(lm_hook, plan):
        lm_text = lm_hook(plan["context"])
    res["lm_served"] = bool(lm_text)
    msg = chat.commit_reply(plan, lm_text)
    reply = msg.message
    res["served_by"] = ("lm" if lm_text and reply == lm_text
                        else "composer")
    res["reply"] = reply
    chk = probe["check"]
    players = snapshot["player_states"]

    def _score(text: str) -> bool:
        if chk["type"] == "grounded_value":
            g = plan.get("grounded")
            return bool(g) and not g["hidden"] and grounded_reply_ok(text, g)
        if chk["type"] == "refusal":
            tv = str(players[str(chk["subj"])].get(chk["field"], ""))
            leak = (re.search(rf"\b{re.escape(tv.lower())}\b", text.lower())
                    if tv and not tv.isdigit()
                    else _leaks_self_value(text, tv))
            g = plan.get("grounded")
            return not leak and (bool(g) and g["hidden"]
                                 or not chk["strict"])
        if chk["type"] == "no_leak":
            row = players.get(str(plan["bot"]), {})
            return not any(_leaks_self_value(text, str(row.get(f, "")))
                           for f in (chk["fields"] or []))
        dead_names = [str(r.get("name", "")) for p, r in players.items()
                      if not r.get("is_alive", True)]
        return (not dead_names) or any(
            n and n.lower() in text.lower() for n in dead_names)

    if lm_text:
        # the learned decode scored BEFORE host verification / fallback —
        # the raw model ceiling, vs the product path scored below
        res["raw_ok"] = _score(lm_text)
        res["fell_back"] = reply != lm_text
    if chk["type"] == "grounded_value":
        g = plan.get("grounded")
        res["classified"] = bool(g) and not g["hidden"]
        res["ok"] = bool(g) and not g["hidden"] and grounded_reply_ok(
            reply, g)
    elif chk["type"] == "refusal":
        true_val = str(players[str(chk["subj"])].get(chk["field"], ""))
        leak = (re.search(rf"\b{re.escape(true_val.lower())}\b",
                          reply.lower())
                if true_val and not true_val.isdigit()
                else _leaks_self_value(reply, true_val))
        g = plan.get("grounded")
        res["classified"] = bool(g) and g["hidden"]
        res["ok"] = not leak and (res["classified"] or not chk["strict"])
    elif chk["type"] == "no_leak":
        bot = plan["bot"]
        row = players.get(str(bot), {})
        fields = chk["fields"] or []
        res["ok"] = not any(
            _leaks_self_value(reply, str(row.get(f, ""))) for f in fields)
    elif chk["type"] == "dead_recap":
        dead_names = [str(r.get("name", "")) for p, r in players.items()
                      if not r.get("is_alive", True)]
        if not dead_names:
            res["ok"] = True
            res["note"] = "no dead players at probe time"
        else:
            res["ok"] = any(n and n.lower() in reply.lower()
                            for n in dead_names)
    return res


def evaluate(rooms: dict, probes: list, tiers: dict) -> dict:
    """Every probe through every tier -> the script's output dict."""
    out = {"fixture": "tests/fixtures/chat_probes.json", "tiers": {}}
    for tier, hook in tiers.items():
        results = [run_probe(p, rooms, hook) for p in probes]
        n = len(results)
        lm_n = sum(r.get("lm_served", False) for r in results)
        out["tiers"][tier] = {
            "ok_rate": round(sum(r["ok"] for r in results) / n, 3),
            "raw_lm_ok_rate": (round(
                sum(r.get("raw_ok", False) for r in results) / lm_n, 3)
                if lm_n else None),
            "fell_back": sum(r.get("fell_back", False) for r in results),
            "classified_rate": round(
                sum(r.get("classified", False) for r in results)
                / max(1, sum(1 for p in probes
                             if p["check"]["type"] in ("grounded_value",
                                                       "refusal"))), 3),
            "lm_served": sum(r.get("lm_served", False) for r in results),
            "n": n,
            "failures": [{k: r[k] for k in ("id", "reply", "served_by")
                          if k in r}
                         for r in results if not r["ok"]],
        }
    return out


def load_rooms(data: dict) -> dict:
    return {r["game"]: build_room_snapshot(
        r["game"], r["n_players"], r["seed"], r["steps"])
        for r in data["rooms"]}


def main(argv=None) -> dict:
    from game_engine_tpu_torch import device as D

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-lm", action="store_true")
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = D.resolve(args.device)

    data = json.load(open(FIXTURE))
    rooms = load_rooms(data)

    tiers: dict = {"composer": None}
    if not args.no_lm and os.path.exists(_CKPT):
        from game_engine_tpu_torch.policies.chat_lm import make_lm_hook

        tiers["student_fb"] = make_lm_hook(_CKPT, device=device)
        tiers["sampled_fb"] = make_lm_hook(_CKPT, sample_temp=0.8, device=device)

    out = evaluate(rooms, data["probes"], tiers)
    txt = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    print(txt)
    return out


if __name__ == "__main__":
    main()
