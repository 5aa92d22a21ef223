"""Learned intent classifier for the DSL generator's blind spot.

`generate.keyword_selection` dispatches archetypes from literal regex
vocabularies; when NONE of them fire, the cascade falls through to the
"rounds" default even for descriptions whose mechanics are obvious from
context ("every sundown the coven quietly removes a townsfolk"). The
reference covers this with a gpt-5 call (reference:
agent/dsl_agent.py:157-371); with zero egress we instead distill the
description -> archetype mapping into a hashed char/word-ngram linear
softmax model — ~430 KB of weights, microsecond inference, fully
deterministic (stable crc32 feature hashing; argmax decode).

Honesty contract: the learned tier only ever picks one of the SAME 13
archetypes the deterministic generator can build — it widens what the
generator *understands*, not what it can *express*. It is consulted
exactly where the keyword cascade matched nothing (so every existing
byte-pinned generator output is untouched), must clear a confidence
threshold calibrated on held-out data, and its choice is reported to the
caller as a NOTE next to the usual coverage warning.

Train/eval: `python -m game_engine_tpu_torch.dslgen.intent train` — the corpus
(intent_corpus.py) holds out synonym and template partitions, and metrics
are reported overall AND on the regex-blind subset (the only traffic the
tier serves in production). The shipped checkpoint lives at
docs/checkpoints/dslgen_intent.npz with a metrics sidecar.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import zlib
from typing import Any, Optional

import numpy as np

DIM = 8192
_FEAT_VERSION = 1
_WORD_RE = re.compile(r"[a-z][a-z'-]+")

DEFAULT_CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "checkpoints", "dslgen_intent.npz")


def _tokens(text: str) -> list[str]:
    from game_engine_tpu_torch.dslgen.generate import _STOPWORDS

    words = [w for w in _WORD_RE.findall(text.lower()) if w not in _STOPWORDS]
    toks: list[str] = []
    for w in words:
        toks.append("w:" + w)
        padded = "^" + w + "$"
        for n in (3, 4):
            for i in range(len(padded) - n + 1):
                toks.append("c:" + padded[i : i + n])
    toks.extend("b:" + a + "_" + b for a, b in zip(words, words[1:]))
    return toks


def features(text: str) -> np.ndarray:
    """Hashed bag of word unigrams/bigrams + in-word char 3/4-grams,
    log-scaled and L2-normalized. crc32 hashing is stable across runs and
    Python versions (unlike builtin hash), so a checkpoint's feature space
    is pinned."""
    vec = np.zeros(DIM, np.float32)
    for t in _tokens(text):
        vec[zlib.crc32(t.encode()) % DIM] += 1.0
    vec = np.log1p(vec)
    n = float(np.linalg.norm(vec))
    return vec / n if n > 0 else vec


@dataclasses.dataclass(frozen=True)
class IntentResult:
    archetype: str
    confidence: float
    confident: bool
    probs: dict[str, float]


class IntentModel:
    def __init__(self, W: np.ndarray, b: np.ndarray, classes: list[str],
                 threshold: float):
        self.W, self.b = W.astype(np.float32), b.astype(np.float32)
        self.classes, self.threshold = list(classes), float(threshold)

    def classify(self, text: str) -> IntentResult:
        logits = features(text) @ self.W + self.b
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        i = int(np.argmax(p))
        conf = float(p[i])
        return IntentResult(
            archetype=self.classes[i], confidence=conf,
            confident=conf >= self.threshold,
            probs={c: round(float(v), 4) for c, v in zip(self.classes, p)})

    def save(self, path: str, metrics: Optional[dict] = None) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, W=self.W, b=self.b,
                 classes=np.array(self.classes),
                 threshold=np.float32(self.threshold),
                 feat_version=np.int32(_FEAT_VERSION), dim=np.int32(DIM))
        if metrics is not None:
            with open(os.path.splitext(path)[0] + ".metrics.json", "w") as f:
                json.dump(metrics, f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "IntentModel":
        z = np.load(path, allow_pickle=False)
        if int(z["feat_version"]) != _FEAT_VERSION or int(z["dim"]) != DIM:
            raise ValueError(
                f"checkpoint {path} was built for feature space "
                f"v{int(z['feat_version'])}/dim{int(z['dim'])}, this build "
                f"is v{_FEAT_VERSION}/dim{DIM} — retrain with "
                "`python -m game_engine_tpu_torch.dslgen.intent train`")
        return IntentModel(z["W"], z["b"], [str(c) for c in z["classes"]],
                           float(z["threshold"]))


def train(n_per_class: int = 240, epochs: int = 300, lr: float = 0.05,
          l2: float = 1e-4, seed: int = 0,
          threshold: float = 0.5) -> tuple[IntentModel, dict]:
    """Full-batch Adam softmax regression on the synthetic corpus;
    returns (model, metrics). Trains in seconds on one CPU core — the
    model is deliberately tiny (DIM x 13 linear)."""
    from game_engine_tpu_torch.dslgen.intent_corpus import ARCHETYPES, make_corpus

    classes = list(ARCHETYPES)
    cls_idx = {c: i for i, c in enumerate(classes)}
    pairs = list(make_corpus("train", n_per_class, seed))
    X = np.stack([features(t) for t, _ in pairs])
    y = np.array([cls_idx[l] for _, l in pairs], np.int32)
    n, k = len(pairs), len(classes)
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((DIM, k)) * 0.01).astype(np.float32)
    b = np.zeros(k, np.float32)
    mW = np.zeros_like(W); vW = np.zeros_like(W)
    mb = np.zeros_like(b); vb = np.zeros_like(b)
    onehot = np.zeros((n, k), np.float32)
    onehot[np.arange(n), y] = 1.0
    b1, b2, eps = 0.9, 0.999, 1e-8
    loss = 0.0
    for t in range(1, epochs + 1):
        logits = X @ W + b
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=1, keepdims=True)
        loss = float(-np.log(p[np.arange(n), y] + 1e-12).mean())
        g = (p - onehot) / n
        gW = X.T @ g + l2 * W
        gb = g.sum(axis=0)
        mW = b1 * mW + (1 - b1) * gW; vW = b2 * vW + (1 - b2) * gW * gW
        mb = b1 * mb + (1 - b1) * gb; vb = b2 * vb + (1 - b2) * gb * gb
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        W -= lr * (mW / c1) / (np.sqrt(vW / c2) + eps)
        b -= lr * (mb / c1) / (np.sqrt(vb / c2) + eps)
    model = IntentModel(W, b, classes, threshold)
    metrics = evaluate(model, n_per_class=max(40, n_per_class // 4),
                       seed=seed)
    metrics.update(train_examples=n, epochs=epochs,
                   final_train_loss=round(loss, 4))
    return model, metrics


def evaluate(model: IntentModel, n_per_class: int = 60,
             seed: int = 0) -> dict[str, Any]:
    """Held-out metrics: accuracy overall, on the regex-blind subset
    (keyword cascade matched nothing — the traffic the learned tier
    serves), plus the keyword cascade's own accuracy as the baseline."""
    from game_engine_tpu_torch.dslgen.generate import keyword_selection
    from game_engine_tpu_torch.dslgen.intent_corpus import make_corpus

    total = correct = 0
    blind_total = blind_correct = blind_confident_correct = blind_confident = 0
    kw_correct = 0
    confusion: dict[str, int] = {}
    for text, label in make_corpus("eval", n_per_class, seed):
        res = model.classify(text)
        sel = keyword_selection(text)
        total += 1
        correct += res.archetype == label
        kw_correct += sel["archetype"] == label
        if not sel["matched"]:
            blind_total += 1
            blind_correct += res.archetype == label
            if res.confident:
                blind_confident += 1
                blind_confident_correct += res.archetype == label
        if res.archetype != label:
            key = f"{label}->{res.archetype}"
            confusion[key] = confusion.get(key, 0) + 1
    return {
        "eval_examples": total,
        "accuracy": round(correct / total, 4),
        "keyword_baseline_accuracy": round(kw_correct / total, 4),
        "regex_blind_examples": blind_total,
        "regex_blind_accuracy": round(blind_correct / blind_total, 4)
        if blind_total else None,
        "regex_blind_confident_precision": round(
            blind_confident_correct / blind_confident, 4)
        if blind_confident else None,
        "regex_blind_confident_coverage": round(
            blind_confident / blind_total, 4) if blind_total else None,
        "top_confusions": dict(sorted(confusion.items(),
                                      key=lambda kv: -kv[1])[:8]),
    }


@functools.lru_cache(maxsize=1)
def _default_model() -> Optional[IntentModel]:
    path = os.environ.get("GAME_ENGINE_INTENT_CKPT", DEFAULT_CKPT)
    if not os.path.exists(path):
        return None
    try:
        return IntentModel.load(path)
    except Exception:
        return None


def classify_default(text: str) -> Optional[IntentResult]:
    """Classify with the shipped checkpoint; None when no checkpoint is
    available (the generator then keeps its round-1 'rounds' default).
    Override the path with GAME_ENGINE_INTENT_CKPT (set to an empty/
    missing path to disable the tier entirely)."""
    model = _default_model()
    return model.classify(text) if model is not None else None


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train + eval + save the checkpoint")
    tr.add_argument("--out", default=DEFAULT_CKPT)
    tr.add_argument("--n-per-class", type=int, default=240)
    tr.add_argument("--epochs", type=int, default=300)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--threshold", type=float, default=0.5)
    cl = sub.add_parser("classify", help="classify a description")
    cl.add_argument("text")
    cl.add_argument("--ckpt", default=DEFAULT_CKPT)
    args = ap.parse_args(argv)
    if args.cmd == "train":
        model, metrics = train(n_per_class=args.n_per_class,
                               epochs=args.epochs, seed=args.seed,
                               threshold=args.threshold)
        model.save(args.out, metrics)
        print(json.dumps({"saved": args.out, **metrics}, indent=1))
    else:
        res = IntentModel.load(args.ckpt).classify(args.text)
        print(json.dumps(dataclasses.asdict(res), indent=1))


if __name__ == "__main__":
    main()
