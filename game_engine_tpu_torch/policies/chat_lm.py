"""Tiny on-device chat language model: a byte-level causal transformer that
roleplays the in-game chat bot.

Counterpart of game_engine_tpu/policies/chat_lm.py. The reference's
ChatBotNode is a gpt-4.1-mini call per chat message (reference:
agent/game_agent_v2.py:351-466); the engine's default responder is the
deterministic state-grounded template composer in server/chat.py. This
module is the LEARNED tier of that seam: a ~2M-param transformer with rotary
position encoding (``_rope``), trained by self-distillation from the
template composer over simulated oracle rooms (``build_corpus``,
train/chat_lm.py) and served behind ``ChatRoom(lm_hook=...)`` (``--chat-lm``
on the server CLI). Conditioning is the exact ``server.chat.lm_context``
string; greedy decodes are deterministic, sampled ones a pure function of
(checkpoint, context, salt), so journal replay reproduces chats.

Parameters are a dict of float32 tensors under the JAX package's names, so a
checkpoint written by either package loads in the other (``save``/``load``).
The arithmetic is the JAX module's:

- every product rounds both operands to bfloat16 and accumulates in float32
  (``_dot``); the embedding is a gather from the bf16-rounded table, ``pos``
  is added unrounded, and the tied head multiplies by the rounded table;
- LayerNorm with the biased variance and eps 1e-5 inside the rsqrt;
- the tanh approximation of gelu, written as ``jax.nn.gelu`` writes it;
- rope with float32 frequencies 1/10000^(i/half) and float32 positions;
- attention scores and the mix in plain float32.

Decoding (``greedy_reply``, ``sampled_reply``) picks its route by where the
parameters live: CUDA tensors run the hand-written decode kernels
(policies/chat_decode.py, csrc/chat_decode.cu: the prefill, then the
cluster decode), CPU tensors their plain version, an eager KV-cache loop
(``chat_decode.decode_plain``).
There is no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Optional

import numpy as np
import torch

from game_engine_tpu_torch import device as D

PAD, BOS, SEP, EOS = 0, 1, 2, 3
_NSPECIAL = 4
_LO, _HI = 32, 126  # printable ASCII
VOCAB = _NSPECIAL + (_HI - _LO + 1)  # 99


@dataclasses.dataclass(frozen=True)
class LMConfig:
    d_model: int = 160
    n_layers: int = 3
    n_heads: int = 4
    # ctx incl. roster + quoted boards + the G=/Pe= grounded and persona
    # segments (p99 ctx+reply ≈ 510 bytes over a 30-seed corpus; 448
    # silently clipped the training target of ~16% of pairs)
    max_len: int = 576
    # trained on grounded field Q&A (the context's G= fact segment)? gates
    # whether the serving tier may answer state questions
    # (server.chat.lm_may_serve); old checkpoints load as False
    grounded: bool = False
    # trained with the Pe= persona segment? gates whether serving contexts
    # carry the persona id
    personas: bool = False
    # trained on the v2 intents (rules/history/advice) and their Gd=/Hn=/Wt=
    # context segments? gates whether the serving tier may answer them
    kinds2: bool = False
    # trained with the suspicion Am=/Dn= segments? gates whether serving
    # emits them (server.chat _sus_extra)
    sus2: bool = False


_FOLD = str.maketrans({"—": "-", "–": "-", "’": "'", "“": '"', "”": '"'})


def encode_text(s: str) -> list[int]:
    s = s.translate(_FOLD)
    return [_NSPECIAL + (ord(c) - _LO) for c in s if _LO <= ord(c) <= _HI]


def decode_tokens(toks) -> str:
    return "".join(
        chr(int(t) - _NSPECIAL + _LO) for t in toks
        if _NSPECIAL <= int(t) < VOCAB
    )


def pair_fits(ctx: str, reply: str, cfg: LMConfig) -> bool:
    """True when BOS+ctx+SEP+reply+EOS fits max_len — encode_pair silently
    truncates otherwise, which trains the student on a clipped reply with
    no EOS (run-on decodes). Trainers drop (and count) misfits."""
    return 3 + len(encode_text(ctx)) + len(encode_text(reply)) <= cfg.max_len


def encode_pair(ctx: str, reply: str, cfg: LMConfig) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (L,), loss_mask (L,)) — next-token loss only on the reply+EOS."""
    toks = [BOS] + encode_text(ctx) + [SEP] + encode_text(reply) + [EOS]
    toks = toks[: cfg.max_len]
    sep_at = toks.index(SEP) if SEP in toks else len(toks) - 1
    out = np.full((cfg.max_len,), PAD, np.int32)
    out[: len(toks)] = toks
    # mask[i] marks positions whose NEXT token is a reply/EOS token
    mask = np.zeros((cfg.max_len,), np.float32)
    mask[sep_at: len(toks) - 1] = 1.0
    return out, mask


def init_params(generator: torch.Generator, cfg: LMConfig,
                device=D.DEFAULT) -> dict[str, torch.Tensor]:
    """Fresh parameters drawn from `generator` (a CPU torch.Generator), the
    JAX module's shapes and scales, on `device`."""
    if cfg.d_model % cfg.n_heads != 0:
        raise ValueError(
            f"d_model={cfg.d_model} must be divisible by n_heads={cfg.n_heads}")
    dev = D.resolve(device)
    Dm, H = cfg.d_model, 4 * cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    def lin(i, o):
        return normal(i, o) / np.sqrt(i)

    p: dict[str, torch.Tensor] = {
        "tok": normal(VOCAB, Dm) * 0.02,
        "pos": normal(cfg.max_len, Dm) * 0.02,
        "lnf_s": torch.ones(Dm),
        "lnf_b": torch.zeros(Dm),
    }
    for i in range(cfg.n_layers):
        p[f"ln1_s{i}"] = torch.ones(Dm)
        p[f"ln1_b{i}"] = torch.zeros(Dm)
        p[f"wqkv{i}"] = lin(Dm, 3 * Dm)
        p[f"wo{i}"] = lin(Dm, Dm)
        p[f"ln2_s{i}"] = torch.ones(Dm)
        p[f"ln2_b{i}"] = torch.zeros(Dm)
        p[f"w1{i}"] = lin(Dm, H)
        p[f"b1{i}"] = torch.zeros(H)
        p[f"w2{i}"] = lin(H, Dm)
        p[f"b2{i}"] = torch.zeros(Dm)
    return {k: v.to(dev) for k, v in p.items()}


def params_from_numpy(arrays: dict, device=D.DEFAULT) -> dict[str, torch.Tensor]:
    """JAX (or numpy) arrays by name -> the port's float32 tensors on `device`."""
    dev = D.resolve(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in arrays.items()}


def _bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (round to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _ln(x, s, b):
    m = x.mean(-1, keepdim=True)
    v = torch.square(x - m).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * s + b


def _dot(a, b):
    """bf16 operands, f32 accumulation (jnp.dot with preferred f32)."""
    return _bf(a) @ _bf(b)


_GELU_C = float(np.float32(np.sqrt(2 / np.pi)))


def _gelu(x):
    """jax.nn.gelu(approximate=True), written as JAX writes it."""
    return x * (0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x)))))


def rope_tables(cfg: LMConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (max_len, half): the rope angles pos · freqs in
    float32 for every position, computed on `device`."""
    half = cfg.d_model // cfg.n_heads // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    ang = torch.arange(cfg.max_len, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """Rotary position encoding on the last dim (head dim); cos/sin
    broadcast against x[..., :half]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def forward(params: dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: LMConfig) -> torch.Tensor:
    """tokens (B, L) int -> logits (B, L, V). Causal; PAD keys masked."""
    B, L = tokens.shape
    Dm, nh = cfg.d_model, cfg.n_heads
    hd = Dm // nh
    tokens = tokens.long()
    # the one-hot product of the JAX module is a gather from the rounded
    # table; a second rounding feeds the tied head, as there
    x = _bf(params["tok"])[tokens] + params["pos"][:L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=tokens.device))
    keymask = (tokens != PAD)[:, None, None, :]  # (B,1,1,L)
    cos, sin = rope_tables(cfg, tokens.device)
    cos, sin = cos[:L, None, :], sin[:L, None, :]  # (L,1,half) against (B,L,nh,hd)
    for i in range(cfg.n_layers):
        h = _ln(x, params[f"ln1_s{i}"], params[f"ln1_b{i}"])
        qkv = _dot(h, params[f"wqkv{i}"]).reshape(B, L, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B,L,nh,hd)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = torch.where(causal[None, None] & keymask, att, -1e9)
        att = torch.softmax(att, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, Dm)
        x = x + _dot(o, params[f"wo{i}"])
        h = _ln(x, params[f"ln2_s{i}"], params[f"ln2_b{i}"])
        h = _gelu(_dot(h, params[f"w1{i}"]) + params[f"b1{i}"])
        x = x + _dot(h, params[f"w2{i}"]) + params[f"b2{i}"]
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    return _dot(x, params["tok"].T)  # tied embedding head


def loss_fn(params, tokens, mask, cfg: LMConfig):
    """Next-token cross-entropy over masked (reply) positions."""
    tokens = tokens.long()
    logits = forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    m = mask[:, : nll.shape[1]]
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# corpus: self-distillation from the template composer
# ---------------------------------------------------------------------------

# the round-3 query distribution — held-out evaluation of a checkpoint must
# use the distribution it TRAINED on (a longer list reshuffles every draw)
_QUERIES_V1 = (
    "hello there", "hi everyone", "what's the status?", "who is still alive?",
    "what's happening?", "what's the score?", "who is winning?",
    "any statements yet?", "which one is the lie?", "who do you vote for?",
    "how will you vote?", "I suspect player 2", "player 3 is suspicious",
    "are you the werewolf?", "I think you're lying", "accuse someone",
    "tell me something", "what should we do?",
    # extra status-flavored draws: the alive/fallen roster lines are the
    # hardest copies (long, state-dependent), so they get more corpus share
    "who is left?", "who died?", "status report", "who remains?",
)

_QUERIES = _QUERIES_V1 + (
    # v2 intents (rules/history/advice): replies quote the Gd=/Hn= context
    # segments, so the copy circuit must learn them like the boards
    "what are the rules?", "how do i win?", "what happens in this phase?",
    "what happened?", "catch me up", "who should i vote for?",
    "any advice?", "what should i do?",
)


def _sender_names() -> tuple[str, ...]:
    """Sender names rotate so the model learns to COPY the S= field rather
    than memorize literals: syllable names plus 300 random letter strings."""
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32

    heads = ("Al", "Bo", "Cy", "Da", "El", "Fi", "Gus", "Hana", "Ira", "Jo",
             "Kai", "Lu", "Mira", "Nox", "Oz", "Pia", "Quinn", "Rex", "Sol",
             "Tia", "Uma", "Vik", "Wyn", "Xan", "Yara", "Zed")
    tails = ("", "ra", "den", "lo", "mi", "ta", "vik", "sh", "na", "rik",
             "el", "issa")
    out = dict.fromkeys(["Viewer", "V"] + [f"player{k}" for k in range(2, 13)])
    for j, h in enumerate(heads):
        for k, t in enumerate(tails):
            name = h + t
            if (j + k) % 3 == 1:
                name = name.lower()
            out.setdefault(name)
    for i in range(300):
        h = splitmix32(0xC0FFEE + i)
        ln = 3 + h % 7
        cs = []
        for k in range(ln):
            h = splitmix32(h)
            cs.append(chr(ord("a") + h % 26))
        name = "".join(cs)
        h = splitmix32(h)
        if h % 3 == 0:
            name = name.capitalize()
        elif h % 3 == 1:
            name += str(h % 10)
        out.setdefault(name)
    return tuple(out)


_SENDERS = _sender_names()


def _rand_name(h: int) -> str:
    """Collision-rich synthetic handle from a hash: roster names must be
    effectively unique across the corpus, or the student memorizes pool
    bigrams instead of learning to COPY the roster from its context."""
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32

    ln = 3 + h % 7
    cs = []
    for _ in range(ln):
        h = splitmix32(h)
        cs.append(chr(ord("a") + h % 26))
    name = "".join(cs)
    h = splitmix32(h)
    if h % 3 == 0:
        name = name.capitalize()
    elif h % 4 == 0:
        name += str(h % 10)
    return name


def _grounded_query(fields: list[str], players: dict, h: int) -> str:
    """A state question naming a declared field (and sometimes a subject
    player), phrased so server.chat._field_answer resolves it."""
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32

    f = fields[h % len(fields)]
    fw = f.replace("_", " ")
    h = splitmix32(h)
    pids = sorted(int(p) for p in players)
    subj = pids[h % len(pids)]
    subj_name = str(players.get(str(subj), {}).get("name") or f"Player {subj}")
    h = splitmix32(h)
    forms = (
        f"what is your {fw}?",
        f"what is {subj_name}'s {fw}?",
        f"how many {fw} do you have?",
        f"tell me your {fw}",
        f"what's player {subj}'s {fw}?",
        f"do you have {fw}?",
    )
    return forms[h % len(forms)]


def build_corpus(games=("werewolf", "two-truths-and-a-lie"), seeds=range(150),
                 max_pairs: int = 30000,
                 queries: Optional[tuple] = None) -> list[tuple[str, str]]:
    """(context, reply) pairs harvested by playing oracle rooms and asking
    the template composer at every phase step. Deterministic, and equal
    pair for pair to the JAX module's.

    Pairs come from plan_reply directly (context and composed reply are
    both in the plan), so grounded field answers are trained too: one of
    the four per-step draws asks about a declared state field, with the
    room's real field visibility so hidden-field refusals are learned."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.oracle.interp import OracleRoom
    from game_engine_tpu_torch.policies.net import field_visibility
    from game_engine_tpu_torch.policies.scripted import oracle_policy
    from game_engine_tpu_torch.server.chat import ChatRoom, phase_guide_from_spec

    pairs: list[tuple[str, str]] = []
    # per-game quota: each game gets an equal share of max_pairs (the
    # quota's slack is not redistributed, as in the JAX module)
    quota = max(1, max_pairs // len(tuple(games)))
    for gname in games:
        game_cap = min(max_pairs, len(pairs) + quota)
        game = compile_game(load_builtin(gname))
        vis = dict(field_visibility(lower(game)))
        for seed in seeds:
            room = OracleRoom(game, n_players=5 + seed % 4, seed=seed)
            ghash = sum(ord(c) for c in gname)
            # a third of rooms keep the server's default handle styles
            # ("player2" / "Bot 3"); the rest get unique synthetic handles
            style = splitmix32((seed * 771 + ghash) & 0xFFFFFFFF) % 6
            for p in room.players:
                if "name" in room.players[p]:
                    if style == 0 and p != 1:  # human creator + default bots
                        room.players[p]["name"] = f"player{p}"
                    elif style == 1 and p != 1:
                        room.players[p]["name"] = f"Bot {p}"
                    else:
                        room.players[p]["name"] = _rand_name(
                            splitmix32((seed * 9176 + p * 331 + ghash) & 0xFFFFFFFF))
            chat = ChatRoom("corpus", seed=seed, visibility=vis,
                            phase_guide=phase_guide_from_spec(game.spec))
            chat.persona_ctx = True
            chat.sus_ctx = True
            fields = sorted(f for f in room.players[1] if f != "name")
            for t in range(400):
                room.step(oracle_policy(room, t, seed))
                # who must act next grounds the advice intent's Wt= flag
                nxt = {} if room.done else oracle_policy(room, t + 1, seed)
                snap = {
                    "player_states": {str(p): dict(row) for p, row in room.players.items()},
                    "current_phase_name": room.phase.name,
                    "deadPlayers": [
                        p for p, row in room.players.items()
                        if not row.get("is_alive", True)
                    ],
                    "waiting_on": [1] if 1 in nxt else [],
                }
                # four (sender, query) draws a step; draw 3 is a grounded
                # field question
                for j in range(4):
                    if j == 3 and fields:
                        q = _grounded_query(
                            fields, snap["player_states"],
                            splitmix32((seed * 131 + t * 17 + 5) & 0xFFFFFFFF))
                    else:
                        qs = queries or _QUERIES
                        q = qs[(seed * 7 + t + j * 5) % len(qs)]
                    who = _SENDERS[(seed * 5 + t * 3 + j * 101) % len(_SENDERS)]
                    chat.post(1, who, q)
                    plan = chat.plan_reply(1, who, q, snap)
                    if plan is not None:
                        # a pinned `queries` tuple means a legacy-distribution
                        # eval: drop pairs the current keyword table sends to
                        # the v2 kinds; the reply is still committed so the
                        # message stream evolves as serving would
                        if not (queries is not None and re.search(
                                r"\|(Gd|Hn|Wt)=", plan["context"])):
                            pairs.append((plan["context"], plan["composed"]))
                        chat.commit_reply(plan, None)
                    if len(pairs) >= game_cap:
                        break
                if room.done or len(pairs) >= game_cap:
                    break
            if len(pairs) >= game_cap:
                break
        if len(pairs) >= max_pairs:
            break
    return pairs


# ---------------------------------------------------------------------------
# decoding + serving hook
# ---------------------------------------------------------------------------


def _prompt_buf(cfg: LMConfig, ctx: str) -> tuple[np.ndarray, int]:
    # keep the FULL context (training saw it untruncated); generation just
    # uses whatever room is left
    toks = [BOS] + encode_text(ctx)[: cfg.max_len - 2] + [SEP]
    buf = np.full((cfg.max_len,), PAD, np.int32)
    buf[: len(toks)] = toks
    return buf, len(toks)


def _finish_reply(out_buf: np.ndarray, n0: int, max_new: int) -> str:
    gen = out_buf[n0:].tolist()
    hit_eos = False
    reply_toks = []
    for t in gen[:max_new]:
        if t == EOS or t < _NSPECIAL:
            hit_eos = True
            break
        reply_toks.append(t)
    out = decode_tokens(reply_toks).strip()
    if not hit_eos:
        # budget exhausted before EOS: keep only COMPLETE sentences; with
        # none, hand the turn to the template tier ("" -> hook returns None)
        cut = max(out.rfind("."), out.rfind("!"), out.rfind("?"))
        return out[: cut + 1] if cut > 0 else ""
    return out


DECODE_CHUNK = 64  # contexts a decode call: the caches of 64 are 330 MB at the shipped size


def _decode(params, cfg: LMConfig, ctxs: list, max_new: int, us=None,
            inv_temp: float = 1.0, top_p: float = 1.0) -> list:
    """Replies for a batch of contexts: the decode kernels for CUDA params
    (one kernel_decode call a chunk of DECODE_CHUNK contexts), their plain
    version for CPU params. Both stop a context at its first generated
    token below _NSPECIAL or after max_new tokens, which is all
    _finish_reply reads of the JAX decoder's full-length buffer; a
    context's reply does not depend on the others in its batch."""
    from game_engine_tpu_torch.policies import chat_decode as CD

    dev = params["tok"].device
    out = []
    for at in range(0, len(ctxs), DECODE_CHUNK):
        chunk = ctxs[at: at + DECODE_CHUNK]
        bufs, n0 = zip(*(_prompt_buf(cfg, c) for c in chunk))
        bufs = np.stack(bufs)  # checked on the host, one copy to the device
        u = None if us is None else np.stack(us[at: at + DECODE_CHUNK])
        if dev.type == "cuda":
            toks, _ = CD.kernel_decode(CD.packed(params, cfg), bufs, n0, max_new, u=u,
                                       inv_temp=inv_temp, top_p=top_p)
        else:
            toks, _ = CD.decode_plain(params, cfg, bufs, n0, max_new, u=u,
                                      inv_temp=inv_temp, top_p=top_p)
        toks = toks.cpu().numpy()
        out += [_finish_reply(t, k, max_new) for t, k in zip(toks, n0)]
    return out


def greedy_reply(params, cfg: LMConfig, ctx: str, max_new: int = 320) -> str:
    """Deterministic greedy decode of a reply for a context string.

    Returns "" (caller falls back to the template tier) when the decode
    runs out of token budget before EOS with no complete sentence. The 320
    budget covers the longest composed kind (rules)."""
    return _decode(params, cfg, [ctx], max_new)[0]


def greedy_replies(params, cfg: LMConfig, ctxs: list, max_new: int = 320) -> list:
    """greedy_reply of each context, decoded in batches."""
    return _decode(params, cfg, list(ctxs), max_new)


def _ctx_uniforms(ctx: str, length: int, salt: int = 0) -> np.ndarray:
    """(length,) uniforms in [0,1) derived from the context by splitmix32 —
    the roleplay tier's randomness is a pure function of (ctx, salt)."""
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32

    h = (2166136261 ^ salt) & 0xFFFFFFFF
    for ch in ctx:
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF  # FNV-1a fold
    out = np.empty((length,), np.float64)
    for i in range(length):
        h = splitmix32((h + 0x9E3779B9) & 0xFFFFFFFF)
        out[i] = h / 4294967296.0
    return out.astype(np.float32)


def sampled_reply(params, cfg: LMConfig, ctx: str, *, temperature: float = 0.8,
                  top_p: float = 0.9, salt: int = 0,
                  max_new: int = 320) -> str:
    """Top-p/temperature decode for the roleplay tier. Deterministic per
    (checkpoint, ctx, salt): the uniforms come from _ctx_uniforms. Same
    truncation discipline as greedy_reply."""
    # the floor only guards div-by-zero: temperature -> 0 concentrates the
    # nucleus on the argmax
    return _decode(params, cfg, [ctx], max_new, us=[_ctx_uniforms(ctx, cfg.max_len, salt)],
                   inv_temp=float(np.float32(1.0 / max(temperature, 1e-6))),
                   top_p=float(np.float32(top_p)))[0]


def save(path: str, params: dict[str, Any], cfg: LMConfig) -> None:
    """The JAX module's .npz format: one array a parameter, the config as
    JSON under __config__."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, __config__=json.dumps(dataclasses.asdict(cfg)),
             **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in params.items()})


def load(path: str, device=D.DEFAULT) -> tuple[dict[str, torch.Tensor], LMConfig]:
    z = np.load(path, allow_pickle=False)
    cfg = LMConfig(**json.loads(str(z["__config__"])))
    params = params_from_numpy({k: z[k] for k in z.files if k != "__config__"}, device)
    return params, cfg


# kinds with no factual payload: the only kinds the roleplay tier may
# sample. Everything that reports state stays greedy.
SAMPLE_KINDS = frozenset({"greeting", "default"})
_CTX_KIND_RX = re.compile(r"^K=([a-z0-9_]+)\|")
SALTS = (0, 1, 2)  # the sampled tier's retry schedule


def _ctx_names(ctx: str) -> list[str]:
    """Player names a reply might address: the sender (S=) plus the roster
    (Ns=). Used by the sampled tier's name guard."""
    names = []
    m = re.search(r"\|S=([^|]+)", ctx)
    if m:
        names.append(m.group(1))
    m = re.search(r"\|Ns=([^|]*)", ctx)
    if m:
        names += [e.split(":", 1)[1] for e in m.group(1).split(",")
                  if ":" in e]
    return [n for n in {n.strip() for n in names} if len(n) >= 3]


def names_intact(out: str, ctx: str) -> bool:
    """True when every word in ``out`` that contains a known player name IS
    that name exactly (case-sensitive containment: a garble extends the
    copied name verbatim, "Vee" -> "Veee")."""
    words = set(re.findall(r"[A-Za-z0-9_']+", out))
    for nm in _ctx_names(ctx):
        for w in words:
            if w != nm and nm in w:
                return False
    return True


_WARMUP_CTX = "K=greeting|P=warmup|B=1|N=P|S=V|A=1|D=|V=0|R=0|Q=hi"


def make_lm_hook(ckpt_path: str, sample_temp: float = 0.0,
                 sample_top_p: float = 0.9, device=D.DEFAULT):
    """Load a checkpoint onto `device` and return the ChatRoom lm_hook
    callable.

    ``sample_temp > 0`` enables the roleplay tier: smalltalk kinds
    (SAMPLE_KINDS, parsed from the context's ``K=`` prefix) decode with
    top-p/temperature sampling, retrying with the salts of SALTS while a
    decode garbles a player name, then greedy; an empty greedy decode
    returns None (the template composer answers). State-reporting kinds
    always decode greedy.

    The warm-up decodes run here: on the card they build the decode kernel
    and pack the weights, so the first chat message pays no nvcc inside the
    server."""
    params, cfg = load(ckpt_path, device)
    greedy_reply(params, cfg, _WARMUP_CTX, max_new=2)
    if sample_temp > 0:
        sampled_reply(params, cfg, _WARMUP_CTX, temperature=sample_temp,
                      top_p=sample_top_p, max_new=2)

    def hook(ctx: str) -> Optional[str]:
        if sample_temp > 0:
            m = _CTX_KIND_RX.match(ctx)
            if m and m.group(1) in SAMPLE_KINDS:
                for salt in SALTS:
                    out = sampled_reply(params, cfg, ctx,
                                        temperature=sample_temp,
                                        top_p=sample_top_p, salt=salt)
                    if out and names_intact(out, ctx):
                        return out
        return greedy_reply(params, cfg, ctx) or None

    hook.grounded = bool(cfg.grounded)
    hook.personas = bool(cfg.personas)
    hook.kinds2 = bool(cfg.kinds2)
    hook.sus2 = bool(cfg.sus2)
    hook.sampling = sample_temp > 0
    hook.params, hook.cfg = params, cfg
    return hook
