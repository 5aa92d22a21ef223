"""unroll_ms: the unroll of a train step (train/ppo.py make_unroll: OB, K2,
SA, ST's step_reset) and its bootstrap value and GAE, by the program's own
span metrics["unroll_ms"] (CUDA events), total over the traced steps over
their count."""


def read(cell, run):
    spans = run.traced.get("spans")
    return sum(u for u, _ in spans) / len(spans) if spans else None
