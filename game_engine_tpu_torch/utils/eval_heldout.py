"""Held-out generator evaluation on game descriptions written upstream of
this repository (tests/fixtures/heldout_descriptions.json: the reference's
draft YAML paraphrases, its generation-prompt examples and its
game_describe.md, frozen verbatim with their sources).

Counterpart of game_engine_tpu/utils/eval_heldout.py, with the same rows
and summary keys. Per item:
  * archetype-pick accuracy  the picked base archetype lies in the item's
                             accepted set;
  * pick tier                keyword cascade or learned intent fallback;
  * description coverage     the generator's own honesty metric;
  * compile ok               generated doc -> validate -> compile_game;
  * terminates               an oracle rollout under scripted random play
                             reaches done within the step cap (2 seeds x
                             2 table sizes).

    python -m game_engine_tpu_torch.utils.eval_heldout [--out FILE]

Everything here runs on the host (the generator, the compiler and the
oracle interpreter): the script has no device path, so it takes no
--device.
"""

from __future__ import annotations

import argparse
import json
import os

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                       "fixtures", "heldout_descriptions.json")


def evaluate_item(item: dict, max_steps: int = 400) -> dict:
    from game_engine_tpu_torch.dslgen.generate import (
        description_coverage, generate_from_description, keyword_selection)
    from game_engine_tpu_torch.dslgen.validate import validate_doc
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.oracle.interp import OracleRoom
    from game_engine_tpu_torch.policies.scripted import oracle_policy

    desc = item["description"]
    sel = keyword_selection(desc)
    cov = description_coverage(desc)
    report: list[str] = []
    res = {
        "id": item["id"],
        "expected": item["expected"],
        "picked": sel["archetype"],
        "keyword_matched": bool(sel["matched"]),
        "extras": list(sel.get("extras") or ()),
        "coverage": round(cov["score"], 3),
        "tier": "keyword",
    }
    try:
        doc = generate_from_description(item["id"], desc, report=report)
    except Exception as e:  # noqa: BLE001 — a failed generation is a row, not a crash
        res.update(generate_error=repr(e), compile_ok=False, terminates=False, pick_ok=False)
        return res
    if any("learned intent" in n for n in report):
        res["tier"] = "learned"
        # the learned tier may override the cascade's default pick
        for n in report:
            if "picked the '" in n:
                res["picked"] = n.split("picked the '")[1].split("'")[0]
    res["pick_ok"] = res["picked"] in item["expected"]
    res["warnings"] = [w.split(" — ")[0] for w in report if w.startswith("WARNING")]
    try:
        issues, spec = validate_doc(doc, name=item["id"])
        hard = [i for i in issues if getattr(i, "severity", "error") == "error"]
        if spec is None or hard:
            res.update(compile_error=[str(i) for i in (hard or issues)][:5],
                       compile_ok=False, terminates=False)
            return res
        compiled = compile_game(spec)
        res["compile_ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed compile is a row, not a crash
        res.update(compile_error=repr(e), compile_ok=False, terminates=False)
        return res

    term, runs = 0, 0
    lo = int(spec.declaration.min_players)
    for n in (lo, lo + 2):
        for seed in (0, 7):
            runs += 1
            room = OracleRoom(compiled, n_players=n, seed=seed)
            for t in range(max_steps):
                if room.done:
                    term += 1
                    break
                room.step(oracle_policy(room, t, seed))
            else:
                if room.done:
                    term += 1
    res["terminates"] = term == runs
    res["terminated_runs"] = f"{term}/{runs}"
    return res


def evaluate(items: list) -> dict:
    """{"fixture", "summary", "rows"} over the fixture's items."""
    rows = [evaluate_item(it) for it in items]
    n = len(rows)
    summary = {
        "n": n,
        "pick_acc": round(sum(r["pick_ok"] for r in rows) / n, 3),
        "compile_rate": round(sum(r["compile_ok"] for r in rows) / n, 3),
        "termination_rate": round(sum(r["terminates"] for r in rows) / n, 3),
        "mean_coverage": round(sum(r["coverage"] for r in rows) / n, 3),
        "learned_tier_used": sum(r["tier"] == "learned" for r in rows),
    }
    return {"fixture": "tests/fixtures/heldout_descriptions.json", "summary": summary,
            "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    with open(FIXTURE, encoding="utf-8") as f:
        out = evaluate(json.load(f)["items"])
    txt = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(txt + "\n")
    print(txt)
    return out


if __name__ == "__main__":
    main()
