"""update_ms: the learner's epochs of a train step (train/ppo.py
make_update: K4 and Adam), by the program's own span metrics["update_ms"]
(CUDA events), total over the traced steps over their count."""


def read(cell, run):
    spans = run.traced.get("spans")
    return sum(u for _, u in spans) / len(spans) if spans else None
