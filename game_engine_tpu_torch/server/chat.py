"""In-game chat: message store, visibility controls, bot responder.

Mirrors the reference chat path: messages are sent as
"Player X in game chat: ..." or "Player X to Bot N: ..." (reference:
src/app/page.tsx:321-351), routed to ChatBotNode which roleplays a bot
reply via addBotChatMessage with visibility controls (reference:
agent/game_agent_v2.py:351-466, src/lib/canvas/types.ts:324-336). Here the
responder is deterministic and state-aware: the addressed (or a pertinent
alive) bot answers from phase context; dead players never speak (reference:
game_agent_v2.py:438-441). Private replies carry target_audience ids.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import time
from typing import Any, Optional

from game_engine_tpu_torch.gamespec.mechanics import splitmix32

_TO_BOT = re.compile(r"^\s*(?:to\s+bot\s*(\d+)\s*:|@(?:bot\s*)?(\d+)\b)", re.IGNORECASE)


@dataclasses.dataclass
class ChatMessage:
    id: str
    playerId: str
    playerName: str
    message: str
    timestamp: float
    type: str = "message"  # message | system | action | broadcast
    visibility: str = "public"  # public | private | hidden
    target_audience: Optional[list[str]] = None

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_KEYWORDS = [
    # v2 intents (advice/rules/history) outrank everything: "who should I
    # vote for" must not fall into the bot's own-vote intent, "what is
    # this phase" must beat the status keyword 'phase', and a greeting
    # prefix ("hey, any advice?") should not eat the actual question
    (re.compile(
        r"\bwho should (?:i|we) (?:vote|pick|choose|target)\b|"
        r"\bwhat should (?:i|we) (?:do|pick|choose|play|vote)\b|"
        r"\bany (?:advice|tips)\b|\bhelp me (?:decide|choose|pick|out)\b",
        re.IGNORECASE), "advice"),
    # rules/history stems are deliberately narrow: a bare \brules?\b would
    # hijack "no rules against that, right?" and a bare \bso far\b would
    # hijack "what's the score so far?" away from their real intents
    (re.compile(
        r"\bwhat (?:are|'re) the rules\b|\brules\s*\?|"
        r"\bhow (?:does|do) (?:this|the game|it) work\b|"
        r"\bhow to play\b|\bhow do (?:i|we|you) win\b|"
        r"\bwhat happens (?:now|next|in this phase)\b|"
        r"\bwhat(?:'s| is) this phase\b|\bexplain the (?:game|rules)\b",
        re.IGNORECASE), "rules"),
    (re.compile(
        r"\bwhat(?:'s| has| have)? happened\b|\bwho (?:died|fell)\b|"
        r"\brecap\b|\bcatch me up\b",
        re.IGNORECASE), "history"),
    (re.compile(r"\b(hi|hello|hey)\b", re.IGNORECASE), "greeting"),
    (re.compile(r"\b(status|phase|alive|who(?:'s| is)? (?:left|remaining|dead)|happening)\b", re.IGNORECASE), "status"),
    (re.compile(r"\b(score|points|standings|winning)\b", re.IGNORECASE), "score"),
    (re.compile(r"\b(statements?|lie|truth)\b", re.IGNORECASE), "statements"),
    (re.compile(r"\bvote|voting|eliminate|lynch\b", re.IGNORECASE), "vote"),
    (re.compile(r"\b(suspect|suspicious|liar|werewolf|assassin|accuse|guilty)\b", re.IGNORECASE), "suspicion"),
]

# Intents added after the round-3 checkpoint shipped: their lm_context
# carries kind-specific segments (Gd=/Hn=/Wt=), so only a checkpoint
# trained on them (cfg.kinds2 -> hook.kinds2) may serve them; older hooks
# get the template tier and keep byte-identical contexts for the original
# kinds.
_V2_KINDS = frozenset({"advice", "rules", "history"})

# "player 3" / "@3" mentions, for the accusation tracker
_MENTION = re.compile(r"(?:player\s*|@)(\d+)", re.IGNORECASE)


def phase_guide_from_spec(spec) -> dict:
    """Compact rules digest the chat responder can quote: per-phase
    description + completion sentence keyed by LOWERCASED phase name, plus
    the game's win/summary text under "__win__". The reference ChatBotNode
    answers rules questions because the full DSL rides its prompt
    (reference: agent/game_agent_v2.py:385-416); this is the determinized
    slice the template tier and the distilled LM can both ground on."""
    from game_engine_tpu_torch.gamespec.schema import CompletionType

    def _clean(s, n=110):
        s = " ".join(str(s or "").split())
        return (s[: n - 1].rstrip() + "…") if len(s) > n else s

    guide: dict[str, Any] = {}
    # by ascending phase id, first-writer-wins: phase names that collide
    # after lowercasing (legal in the DSL) deterministically keep the
    # earliest phase's digest instead of silently quoting the last one
    for pid in sorted(spec.phases):
        ph = spec.phases[pid]
        if ph.name.lower() in guide:
            continue
        done = _clean(ph.completion.description, 60)
        if not done:
            done = {
                CompletionType.TIMER: "the timer runs out",
                CompletionType.UI_DISPLAYED: "the board is shown",
            }.get(ph.completion.type,
                  _clean(ph.completion.target_description, 60)
                  or "everyone has acted")
        guide[ph.name.lower()] = {"desc": _clean(ph.description),
                                  "done": done}
    guide["__win__"] = _clean(spec.declaration.description, 140)
    return guide


def _pname(players: dict, pid) -> str:
    return players.get(str(pid), {}).get("name") or f"Player {pid}"


def _alive_board(players: dict) -> str:
    alive = [pid for pid, row in players.items() if row.get("is_alive", True)]
    return ", ".join(_pname(players, p) for p in sorted(alive, key=int))


def _fallen_board(players: dict, dead) -> str:
    return ", ".join(_pname(players, d) for d in dead)


def _facts_board(players: dict, bot: int, visibility: dict) -> str:
    """The bot's public scalar standing ("is alive yes, coins 3, ...") —
    rendered ONCE here so the composer's fallback and the LM context agree
    byte-for-byte (the student can only learn facts its context contains)."""
    me = players.get(str(bot), {})
    facts = []
    for f, v in me.items():
        if f == "name" or (visibility or {}).get(f, 0) != 0:
            continue
        if isinstance(v, bool):
            facts.append(f"{f.replace('_', ' ')} {'yes' if v else 'no'}")
        elif isinstance(v, (int, float)):
            facts.append(f"{f.replace('_', ' ')} {int(v)}")
        if len(facts) >= 4:
            break
    return ", ".join(facts)


def _score_rows(players: dict) -> list:
    rows = [
        (_pname(players, pid),
         int(row.get("total_score", row.get("score", 0)) or 0))
        for pid, row in players.items()
    ]
    rows.sort(key=lambda r: -r[1])
    return rows


def lm_context(kind: str, bot: int, sender_name: str, text: str,
               snapshot: dict[str, Any], variant: int = 0,
               sus_name: str = "", visibility: Optional[dict] = None,
               grounded: Optional[dict] = None,
               persona: Optional[int] = None, extra: str = "") -> str:
    """Serialize the reply-relevant state into the compact conditioning
    string consumed by the on-device chat LM (policies/chat_lm.py). The SAME
    serializer builds the self-distillation corpus, so serving inputs stay
    in-distribution. This is the seam where the reference sends the full
    game context to gpt-4.1-mini (reference: agent/game_agent_v2.py:385).

    ``variant`` carries the template composer's style-roll (h2 mod 12 —
    12 = lcm of every pool size, so the roll pins the pool index the
    composer will pick; mod 8 left 3-entry pools ambiguous and capped the
    student's exact-match): the
    teacher picks among phrasing variants by a hash that is otherwise
    invisible to the student, which would make the context->reply mapping
    multimodal — greedy decoding then splices modes into garbled text.
    Conditioning on the roll makes the mapping deterministic."""
    players = snapshot.get("player_states", {})
    me = players.get(str(bot), {})
    alive = sorted(
        (int(p) for p, row in players.items() if row.get("is_alive", True)))
    dead = sorted(int(d) for d in snapshot.get("deadPlayers", []))
    my_vote = int(me.get("vote_choice", 0) or 0)
    # roster NAMES ride in the context so every name a reply might quote is
    # available to COPY byte-for-byte — without it the model had to
    # hallucinate unseen handles from the id list ("Marisol" -> "Miralo",
    # the round-2 garble)
    roster = ",".join(
        f"{p}:{str(players.get(str(p), {}).get('name') or f'Player {p}')[:12]}"
        for p in alive[:8])
    # every board the composer can quote rides in the context VERBATIM —
    # a distilled student can only be faithful to facts it is shown
    # (round-3 held-out misses were exactly the boards the context lacked)
    rows = _score_rows(players)
    board = (", ".join(f"{n} {s}" for n, s in rows[:3])
             if any(s for _, s in rows) else "")
    inv = ",".join(
        f"{k}:{v}" for k, v in sorted(
            (me.get("investigated_alignments") or {}).items())[:3])
    # grounded field-question segment (K=field plans only): the subject,
    # field name, VALUE (visible fields only — a hidden field's value is
    # withheld from the context entirely, so the student cannot leak what
    # it never sees) and two flags: p/h public-or-hidden, s/o self-or-other.
    # persona segment (Pe=): the bot's stable voice id — only emitted for
    # persona-trained students (hook.personas), so an older checkpoint
    # keeps byte-identical serving contexts
    pe = f"|Pe={persona}" if persona is not None else ""
    g = ""
    if grounded is not None:
        g = (f"|G={grounded['subj_name'][:12]};{grounded['fname']};"
             f"{grounded['val'] if not grounded['hidden'] else ''};"
             f"{'h' if grounded['hidden'] else 'p'}"
             f"{'s' if grounded['is_self'] else 'o'}")
    return (
        f"K={kind}|P={snapshot.get('current_phase_name') or 'the game'}"
        f"|B={bot}|N={me.get('name') or f'Player {bot}'}"
        f"|S={sender_name}|A={','.join(map(str, alive))}"
        f"|D={','.join(map(str, dead))}|V={my_vote}|R={variant % 12}"
        f"|Ns={roster}|X={sus_name or ''}|L={_alive_board(players)}"
        f"|Fl={_fallen_board(players, snapshot.get('deadPlayers', []))}"
        f"|F={_facts_board(players, bot, visibility)}"
        f"|Sc={board}|I={inv}{pe}{g}{extra}|Q={text[:60]}"
    )


# Personas: a deterministic per-(room, bot) voice for the template tier —
# the determinized slice of the reference ChatBotNode's free roleplay
# (agent/game_agent_v2.py:385-416 prompts gpt for in-character banter; here
# a stable persona colors every composed reply with opening/closing tics
# while the content stays state-grounded). Grounded field answers are NEVER
# decorated: correctness outranks roleplay on exact-value replies.
PERSONAS: tuple[tuple[str, tuple[str, ...], tuple[str, ...]], ...] = (
    ("gruff", ("Hmph.", "Make it quick."),
     ("Enough talk.", "Back to it.")),
    ("cheery", ("Oh hey!", "Ooh —"),
     ("This is fun!", "Good luck out there!")),
    ("cryptic", ("The signs are plain.", "As foretold —"),
     ("Watch the shadows.", "All is not what it seems.")),
    ("nervous", ("Oh, um —", "Wait, wait."),
     ("I don't like this one bit.", "Let's be careful, alright?")),
    ("braggart", ("Listen up.", "Easy one."),
     ("Nobody reads this table like me.", "You'll see I'm right.")),
    ("dry", ("Noted.", "Sure."),
     ("Thrilling.", "Carry on.")),
)


def persona_of(seed: int, bot: int) -> int:
    """Stable persona id for a bot in a room — a pure function of the
    room seed and seat, so journal replay and the corpus reproduce it."""
    return splitmix32((seed * 0x9E37 + bot * 7919) & 0xFFFFFFFF) % len(PERSONAS)


def decorate_persona(text: str, pid: int, h: int) -> str:
    """Color a composed reply with the persona's tics: a third of replies
    get the opening tic, a third the closing, a third stay plain — the
    same statement-ordered determinism as every pool pick.

    The roll derives from (h mod 12, pid) ONLY — exactly the values the
    LM context exposes (R= and Pe=) — so the decoration is a pure
    function of the student's conditioning. Hashing the full h made
    byte-identical contexts carry different targets (irreducible noise
    that floors the distillation loss and garbles greedy decodes)."""
    name, opens, closes = PERSONAS[pid]
    h3 = splitmix32(((h % 12) ^ (pid * 0x85EB)) & 0xFFFFFFFF)
    roll = h3 % 3
    if roll == 0:
        return f"{opens[h3 // 3 % len(opens)]} {text}"
    if roll == 1:
        return f"{text} {closes[h3 // 3 % len(closes)]}"
    return text


def _accused_me(me: dict, bot: int, text: str) -> bool:
    """Does the sender's message point at THIS bot? ONE definition shared
    by the composer's suspicion branch and the Am= context segment — they
    must agree or the distilled student's template selection desyncs (the
    r4b residual: suspicion EM 0.597, misses were exactly the accused-me
    vs deflect template flips the raw Q= text underdetermines)."""
    return bool(
        re.search(rf"\byou\b|player\s*{bot}\b", text, re.IGNORECASE)
        or (me.get("name") and str(me["name"]).lower() in text.lower())
    )


def lm_may_serve(lm_hook, plan: dict) -> bool:
    """Whether the learned tier may answer this plan. Plans the composer
    marked LM-eligible (``lm_ok``) always are; grounded field questions
    additionally require a hook that declares grounded training
    (``hook.grounded`` — set by policies.chat_lm.make_lm_hook from the
    checkpoint's config), so an old ungrounded checkpoint keeps the
    round-3 template bypass. The grounded override applies ONLY to
    grounded plans: a v2-intent plan (rules/history/advice) gated off for
    an untrained hook must not leak through on hook.grounded alone."""
    if plan.get("lm_ok", True):
        return True
    if plan.get("grounded") is not None:
        return bool(getattr(lm_hook, "grounded", False))
    return False


_REFUSAL_RE = re.compile(
    r"\b(hidden|secret|private|business|knows|ask|tell(?:ing)?|"
    r"won'?t|can'?t|cannot|not\s+say(?:ing)?)\b", re.IGNORECASE)


def grounded_reply_ok(reply: str, g: dict) -> bool:
    """Deterministic faithfulness check for a learned grounded reply:
    must name the field; visible facts must quote the exact value; hidden
    facts must read as a REFUSAL — a decode that names the field but
    asserts a fabricated value ("My role is werewolf.") used to pass and
    could coincide with (and so leak) the real hidden value."""
    if not re.search(rf"\b{re.escape(g['fname'])}\b", reply, re.IGNORECASE):
        return False
    if g.get("hidden") or g.get("val") is None:
        return _REFUSAL_RE.search(reply) is not None
    return re.search(rf"(?<![\w-]){re.escape(str(g['val']))}(?![\w-])",
                     reply) is not None


def history_reply_ok(reply: str, h: dict) -> bool:
    """Deterministic faithfulness check for a learned HISTORY reply
    (who-died recaps). The chat-probe eval (utils/eval_chat_probes.py)
    caught the student asserting wrong casualty facts — garbled roster
    names ("Playerer3") and "everyone's standing" over real corpses —
    which the grounded-field verifier never sees. Rules:

      * every roster-shaped token in the decode must be a real roster
        name, and every named casualty must actually be dead;
      * when casualties exist, at least one must be named — a "nothing
        happened" recap over real deaths is a wrong fact, not style.

    `h`: {"dead": [names...], "roster": [names...]} from the snapshot."""
    dead = {n.lower() for n in h.get("dead", ()) if n}
    roster = {n.lower() for n in h.get("roster", ()) if n}
    mentioned = {m.group(0).lower()
                 for m in re.finditer(r"\b[A-Z][\w'-]+\b", reply)}
    # tokens that look like roster references (share a roster prefix or
    # contain a digit-suffixed Player handle) must resolve exactly
    for tok in mentioned:
        if tok in roster:
            continue
        if re.match(r"player\w*", tok) or any(
                tok[:4] == n[:4] for n in roster):
            return False
    named_dead = {n for n in dead if re.search(
        rf"\b{re.escape(n)}\b", reply, re.IGNORECASE)}
    named_live = {n for n in roster - dead if re.search(
        rf"\b{re.escape(n)}\b", reply, re.IGNORECASE)}
    if dead:
        if not named_dead:
            return False
        # naming a living player inside a casualty recap misreports them
        # (the composer's recap names only the fallen + a survivor COUNT)
        if named_live:
            return False
    return True


class ChatRoom:
    """Per-room chat log + deterministic bot responder.

    ``lm_hook(context_str) -> Optional[str]`` plugs a learned language
    model in place of the template composer (``--chat-lm`` serves the tiny
    on-device transformer from policies/chat_lm.py); bot selection, dead-
    players-silent, visibility and timestamps stay host-enforced either
    way, and a None/empty hook reply falls back to the templates."""

    def __init__(self, room_id: str, seed: int = 0, lm_hook=None,
                 visibility: Optional[dict[str, int]] = None,
                 phase_guide: Optional[dict] = None):
        self.room_id = room_id
        self.seed = seed
        self.lm_hook = lm_hook
        # per-field observation visibility (policies.net.field_visibility
        # codes: 0 public, 1 self-only, 2 team) — grounded answers reveal
        # public values truthfully and guard hidden ones; None = all public
        self.visibility = visibility or {}
        # phase_guide_from_spec(spec): rules digest for the "rules" intent
        self.phase_guide = phase_guide or {}
        # emit the Pe= persona segment in LM contexts even without a hook
        # (the corpus builder sets this so the student trains on it;
        # serving also emits it whenever the hook declares hook.personas)
        self.persona_ctx = False
        self.sus_ctx = False  # corpus builder: emit Am=/Dn= for suspicion
        self.messages: list[ChatMessage] = []
        self._ids = itertools.count(1)

    def post(self, player_id: int, player_name: str, text: str,
             visibility: str = "public",
             target_audience: Optional[list[str]] = None,
             mtype: str = "message",
             timestamp: Optional[float] = None) -> ChatMessage:
        msg = ChatMessage(
            id=f"{self.room_id}-{next(self._ids)}",
            playerId=str(player_id),
            playerName=player_name,
            message=text,
            timestamp=time.time() if timestamp is None else timestamp,
            type=mtype,
            visibility=visibility,
            target_audience=target_audience,
        )
        self.messages.append(msg)
        return msg

    def system(self, text: str) -> ChatMessage:
        return self.post(0, "System", text, mtype="system")

    def visible(self, viewer_id: int) -> list[ChatMessage]:
        """Visibility gate (reference: types.ts:332-334 semantics)."""
        out = []
        v = str(viewer_id)
        for m in self.messages:
            if m.visibility == "hidden":
                continue
            if m.visibility == "private" and v not in (m.target_audience or []) and m.playerId != v:
                continue
            out.append(m)
        return out

    # -- bot responder ---------------------------------------------------------

    def bot_reply(self, sender_id: int, sender_name: str, text: str,
                  snapshot: dict[str, Any]) -> Optional[ChatMessage]:
        """Generate a deterministic, state-grounded bot reply.

        Addressing: 'to Bot N:' / '@N' selects bot N; otherwise a stable
        hash picks an alive bot (never player 1, never dead players).
        Private messages to a bot get a private reply back.

        Unlike canned keyword pools, replies are composed from actual game
        state — phase, alive/dead roster, the bot's own private knowledge
        (investigation results, vote choices, scores) and the accusation
        history of this chat — the deterministic twin of the reference's
        roleplaying ChatBotNode (reference: agent/game_agent_v2.py:351-466,
        full-game-context prompt; dead players silent :438-441).

        One-shot convenience over plan_reply + commit_reply (the host uses
        the two-phase form so an lm_hook decode can run outside its lock).
        """
        plan = self.plan_reply(sender_id, sender_name, text, snapshot)
        if plan is None:
            return None
        lm_text = (self.lm_hook(plan["context"])
                   if self.lm_hook and lm_may_serve(self.lm_hook, plan)
                   else None)
        return self.commit_reply(plan, lm_text)

    def plan_reply(self, sender_id: int, sender_name: str, text: str,
                   snapshot: dict[str, Any]) -> Optional[dict]:
        """Deterministic half of the responder: pick the bot, classify the
        intent, compose the template reply and the LM context, and capture
        the trigger timestamp — everything that depends on the message list
        being stable. Returns a plan for commit_reply, or None when no bot
        may speak."""
        players = snapshot.get("player_states", {})
        m = _TO_BOT.match(text)
        private = bool(m)
        alive_bots = [
            int(pid)
            for pid, row in players.items()
            if int(pid) != 1 and row.get("is_alive", True)
        ]
        if not alive_bots:
            return None
        if m:
            want = int(m.group(1) or m.group(2))
            if want not in alive_bots:
                return None
            bot = want
            text = text[m.end():].strip() or text
        else:
            h = splitmix32((self.seed * 31 + len(self.messages)) & 0xFFFFFFFF)
            bot = alive_bots[h % len(alive_bots)]

        kind = "default"
        for rx, k in _KEYWORDS:
            if rx.search(text):
                kind = k
                break
        h2 = splitmix32((self.seed + len(self.messages) * 7 + bot) & 0xFFFFFFFF)
        # grounded field answers outrank the intent pools: a question naming
        # a declared state field gets the actual value (or a guarded refusal
        # for hidden fields) — never a deflection
        fact = self._field_answer(bot, sender_id, sender_name, text,
                                  snapshot, h2)
        pid = persona_of(self.seed, bot)
        players_all = snapshot.get("player_states", {})
        sus = self._pick_suspect(bot, sender_id, players_all, h2)
        if fact is not None:
            kind = "field"
            composed = fact["text"]  # never decorated: exact values first
        else:
            composed = decorate_persona(
                self._compose(kind, bot, sender_id, sender_name, text,
                              snapshot, h2, suspect=sus), pid, h2)
        bot_name = players.get(str(bot), {}).get("name") or f"Player {bot}"
        # the reply inherits the triggering message's clock so journal
        # replay reproduces timestamps exactly
        trigger_ts = self.messages[-1].timestamp if self.messages else None
        return {
            "context": lm_context(kind, bot, sender_name, text, snapshot,
                                  variant=h2,
                                  sus_name=_pname(players, sus) if sus else "",
                                  visibility=self.visibility,
                                  grounded=fact,
                                  persona=(pid if (self.persona_ctx or getattr(
                                      self.lm_hook, "personas", False))
                                           else None),
                                  extra=self._v2_extra(kind, sender_id, text,
                                                       snapshot)
                                  + self._sus_extra(kind, bot, text,
                                                    snapshot)),
            "composed": composed,
            # grounded field answers carry exact state values; only an LM
            # trained with the G= fact segment (hook.grounded) may serve
            # them, and commit_reply still verifies the value appears in
            # the decode before trusting it (correctness over roleplay).
            # v2 intents need a hook trained on their context segments
            # (hook.kinds2) — lm_may_serve has no override for them
            "lm_ok": kind != "field" and (
                kind not in _V2_KINDS
                or bool(getattr(self.lm_hook, "kinds2", False))),
            "grounded": ({"fname": fact["fname"], "val": fact["val"],
                          "hidden": fact["hidden"],
                          "subj": fact["subj_name"]} if fact else None),
            "kind": kind,
            # casualty facts for history-decode verification (commit_reply)
            "history": ({
                "dead": [str(r.get("name") or f"Player {p}")
                         for p, r in players_all.items()
                         if not r.get("is_alive", True)
                         or str(p) in set(map(str, snapshot.get(
                             "deadPlayers", ())))],
                "roster": [str(r.get("name") or f"Player {p}")
                           for p, r in players_all.items()],
            } if kind == "history" else None),
            "bot": bot,
            "bot_name": bot_name,
            "private": private,
            "sender_id": sender_id,
            # raw materials for the external-model tier's roleplay prompt
            # (server/chat_llm.py): the addressed text, the sender's name
            # and the persona id the composer would decorate with
            "text": text,
            "sender_name": sender_name,
            "persona": pid,
            "trigger_ts": trigger_ts,
        }

    def commit_reply(self, plan: dict, lm_text: Optional[str]) -> ChatMessage:
        """Post the planned reply — the lm_hook output when non-empty, else
        the deterministic template composition.

        Grounded plans verify the decode before trusting it: a visible
        fact's reply must quote the field name and the exact value, and a
        hidden fact's refusal must still name the field (it CANNOT leak the
        value — the G= context withholds it). A failed check falls back to
        the composed template, so the learned tier is fail-safe on exactly
        the queries where being wrong is worst."""
        g = plan.get("grounded")
        if lm_text and g is not None and not grounded_reply_ok(lm_text, g):
            lm_text = None
        h = plan.get("history")
        if lm_text and h is not None and not history_reply_ok(lm_text, h):
            lm_text = None  # wrong casualty facts -> truthful template
        return self.post(
            plan["bot"], plan["bot_name"], lm_text or plan["composed"],
            visibility="private" if plan["private"] else "public",
            target_audience=[str(plan["sender_id"])] if plan["private"] else None,
            timestamp=plan["trigger_ts"],
        )

    # -- state-grounded composition ---------------------------------------

    def _name(self, players: dict, pid) -> str:
        return players.get(str(pid), {}).get("name") or f"Player {pid}"

    def _rules_text(self, text: str, snapshot: dict) -> str:
        """The guide sentence a rules reply quotes: the win/summary text
        for 'how do I win', else the current phase's digest, else ''."""
        if re.search(r"\bwin\b", text, re.IGNORECASE):
            return self.phase_guide.get("__win__", "")
        phase = snapshot.get("current_phase_name") or ""
        g = self.phase_guide.get(str(phase).lower()) or {}
        desc = g.get("desc", "")
        if desc and g.get("done"):
            return f"{desc} It ends when {g['done']}."
        return desc

    @staticmethod
    def _history_text(snapshot: dict) -> str:
        """The last one or two game-note lines a history reply quotes."""
        notes = [str(n.get("text", "")) for n in
                 snapshot.get("game_notes", []) if n.get("text")]
        return " Then: ".join(t[:90] for t in notes[-2:])

    @staticmethod
    def _advice_up(sender_id: int, snapshot: dict) -> bool:
        """Is the host waiting on the asking player? ONE definition shared
        by the Wt= context segment and the composed advice reply — they
        must agree or the distilled student's grounding desyncs."""
        waiting = snapshot.get("waiting_on") or []
        return any(int(w) == sender_id for w in waiting)

    def _v2_extra(self, kind: str, sender_id: int, text: str,
                  snapshot: dict) -> str:
        """Kind-conditional context segments for the v2 intents — each
        carries VERBATIM the fact text its composed reply quotes (a
        distilled student is only faithful to facts its context shows).
        Original kinds emit nothing, keeping their serving contexts
        byte-identical for pre-v2 checkpoints."""
        if kind == "rules":
            return f"|Gd={self._rules_text(text, snapshot)}"
        if kind == "history":
            return f"|Hn={self._history_text(snapshot)}"
        if kind == "advice":
            return f"|Wt={1 if self._advice_up(sender_id, snapshot) else 0}"
        return ""

    def _sus_extra(self, kind: str, bot: int, text: str,
                   snapshot: dict) -> str:
        """Suspicion-only context segments (r4b residual fix): Am= whether
        the sender accused THIS bot (the composer's template-selection
        branch — raw Q= text underdetermines it at 60 chars) and Dn= the
        dead COUNT (the accused-me template says "N of us are already
        gone"; a char-level student cannot reliably count the D= id list).
        Emitted only when the checkpoint trained on them (hook.sus2) so
        older checkpoints keep byte-identical suspicion contexts."""
        if kind != "suspicion" or not (
                self.sus_ctx or getattr(self.lm_hook, "sus2", False)):
            return ""
        players = snapshot.get("player_states", {})
        me = players.get(str(bot), {})
        dead = snapshot.get("deadPlayers", [])
        return (f"|Am={1 if _accused_me(me, bot, text) else 0}"
                f"|Dn={len(dead)}")

    def _accusation_counts(self, players: dict) -> dict[int, int]:
        """Who has been accused in this chat (mentions near suspicion words)."""
        counts: dict[int, int] = {}
        suspicious = _KEYWORDS[-1][0]
        name_to_pid = {
            str(row.get("name", "")).lower(): int(pid)
            for pid, row in players.items()
            # whole-word matching below; 1-2 char names collide with
            # ordinary words ('Al' in 'all') even then, so skip them
            if row.get("name") and len(str(row["name"])) >= 3
        }
        for msg in self.messages:
            if msg.type != "message" or not suspicious.search(msg.message):
                continue
            low = msg.message.lower()
            for mm in _MENTION.finditer(msg.message):
                counts[int(mm.group(1))] = counts.get(int(mm.group(1)), 0) + 1
            for nm, pid in name_to_pid.items():
                if re.search(rf"\b{re.escape(nm)}\b", low):
                    counts[pid] = counts.get(pid, 0) + 1
        return counts

    def _pick_suspect(self, bot: int, sender_id: int, players: dict,
                      h: int) -> Optional[int]:
        """The bot's current read: most-accused alive player, else hash pick
        (never itself, never the sender, never the dead)."""
        candidates = [
            int(pid) for pid, row in players.items()
            if row.get("is_alive", True) and int(pid) not in (bot, sender_id)
        ]
        if not candidates:
            return None
        counts = self._accusation_counts(players)
        accused = [c for c in candidates if counts.get(c)]
        if accused:
            return max(accused, key=lambda c: (counts[c], -c))
        return candidates[h % len(candidates)]

    # questions that warrant a grounded field answer (casual mentions of a
    # field word in a statement fall through to the intent pools)
    _WEALTH_SYNONYM_RX = re.compile(
        r"\b(rich(?:er|est)?|wealth\w*|purse|fortune|stash|bankroll|"
        r"treasury)\b", re.IGNORECASE)
    _RESOURCE_FIELD_RX = re.compile(
        r"coin|gold|credit|money|chip|resource|token|pearl", re.IGNORECASE)
    _QUESTION_RE = re.compile(
        r"\?|\b(what|how (?:many|much)|tell me|do you|does|have you|are you|"
        r"is (?:your|my|their|his|her))\b", re.IGNORECASE)

    def _field_answer(self, bot: int, sender_id: int, sender_name: str,
                      text: str, snapshot: dict[str, Any],
                      h: int) -> Optional[dict]:
        """P-grounded answer when a QUESTION names a declared player-state
        field: public fields are answered truthfully from the live state
        (any field, any subject player); hidden (self/team-visible) fields
        get a guarded refusal that still names the field — never a generic
        deflection, and never a leak. The reference's ChatBotNode answers
        from the full game context (agent/game_agent_v2.py:351-466); this
        is its determinized twin for state questions.

        Returns None when no declared field is being asked about, else a
        dict: text (the composed answer), subj_name, fname, val (None for
        hidden fields), hidden, is_self — the structured fact that rides
        the LM context's G= segment and verifies a learned reply."""
        if not self._QUESTION_RE.search(text):
            return None
        players = snapshot.get("player_states", {})
        me = players.get(str(bot), {})
        low = text.lower()
        field = None
        for f in me:
            words = f.lower().replace("_", " ")
            pat = rf"\b{re.escape(words)}s?\b|\b{re.escape(f.lower())}s?\b"
            if re.search(pat, low):
                field = f
                break
        if field is None and self._WEALTH_SYNONYM_RX.search(low):
            # paraphrase tier: "how rich is X" / "X's purse" grounds to the
            # game's declared resource field even though no field is named
            # (chat-probe eval witness: gr_coins_paraphrase) — numeric
            # fields only, first declared resource-named one wins
            for f, v in me.items():
                if (isinstance(v, int) and not isinstance(v, bool)
                        and self._RESOURCE_FIELD_RX.search(f)):
                    field = f
                    break
        if field is None or field == "name":
            return None
        # subject: an explicit player mention/name, else the bot itself
        subject = bot
        m = _MENTION.search(text)
        if m:
            subject = int(m.group(1))
        else:
            for pid, row in players.items():
                nm = str(row.get("name") or "")
                if len(nm) >= 3 and re.search(rf"\b{re.escape(nm.lower())}\b", low):
                    if int(pid) != bot or " my " not in f" {low} ":
                        subject = int(pid)
                    break
        row = players.get(str(subject))
        if row is None or field not in row:
            return None
        fname = field.replace("_", " ")
        vis = self.visibility.get(field, 0)
        subj_name = self._name(players, subject)
        if vis != 0:  # hidden information: refuse by name, never leak
            if subject == bot:
                pool = [
                    f"My {fname} is my business, {sender_name}.",
                    f"Nice try — my {fname} stays hidden until the game says otherwise.",
                ]
            else:
                pool = [
                    f"Only {subj_name} knows their {fname}.",
                    f"You'd have to ask {subj_name} about their {fname} — not that they'd tell you.",
                ]
            return {"text": pool[h % len(pool)], "subj_name": subj_name,
                    "fname": fname, "val": None, "hidden": True,
                    "is_self": subject == bot}
        v = row[field]
        if isinstance(v, bool):
            val = "yes" if v else "no"
        elif isinstance(v, dict):
            val = f"{len(v)} entries"
        elif isinstance(v, (int, float)):
            val = str(int(v))
        else:
            val = str(v) if v else "nothing yet"
        if subject == bot:
            pool = [
                f"My {fname} is {val}.",
                f"{val} — that's my {fname}, {sender_name}.",
            ]
        else:
            pool = [
                f"{subj_name}'s {fname} is {val}.",
                f"Last I looked, {subj_name} has {fname} {val}.",
            ]
        return {"text": pool[h % len(pool)], "subj_name": subj_name,
                "fname": fname, "val": val, "hidden": False,
                "is_self": subject == bot}

    def _compose(self, kind: str, bot: int, sender_id: int, sender_name: str,
                 text: str, snapshot: dict[str, Any], h: int,
                 suspect: Optional[int] = None) -> str:
        players = snapshot.get("player_states", {})
        me = players.get(str(bot), {})
        phase = snapshot.get("current_phase_name") or "the game"
        dead = [str(d) for d in snapshot.get("deadPlayers", [])]
        alive = [pid for pid, row in players.items() if row.get("is_alive", True)]
        if suspect is None:  # plan_reply passes the shared pick; direct
            suspect = self._pick_suspect(bot, sender_id, players, h)  # callers
        sus_name = self._name(players, suspect) if suspect else None

        if kind == "greeting":
            pool = [
                f"Hey {sender_name}! We're in {phase} — {len(alive)} of us still in it.",
                f"Hello {sender_name}. Eyes on {phase}.",
                f"Hi {sender_name} — let's get through {phase}.",
            ]
        elif kind == "status":
            names = _alive_board(players)
            fallen = (" Fallen: " + _fallen_board(players, dead) + "."
                      if dead else "")
            pool = [f"We're in {phase}. Still standing: {names}.{fallen}"]
        elif kind == "score":
            rows = _score_rows(players)
            if any(s for _, s in rows):
                board = ", ".join(f"{n} {s}" for n, s in rows[:3])
                pool = [f"Standings: {board}.",
                        f"{rows[0][0]} leads with {rows[0][1]} — for now."]
            else:
                pool = [f"No points on the board yet — {phase} first."]
        elif kind == "statements":
            speaker = next(
                (pid for pid, row in players.items() if row.get("is_speaker")), None
            )
            stmts = (players.get(speaker, {}).get("statements") or {}) if speaker else {}
            if speaker and stmts:
                pool = [
                    f"{self._name(players, speaker)} gave us {len(stmts)} statements — one smells off to me.",
                    f"Read {self._name(players, speaker)}'s statements again; the lie is in the details.",
                ]
            else:
                pool = [f"No statements on the board yet — we're in {phase}."]
        elif kind == "vote":
            my_vote = int(me.get("vote_choice", 0) or 0)
            if my_vote:
                pool = [
                    f"I've locked my vote on statement {my_vote}.",
                    f"My read says {my_vote} — I'm sticking with it.",
                ]
            elif sus_name:
                pool = [
                    f"When the vote comes, I'm looking at {sus_name}.",
                    f"My vote goes where the evidence points — right now that's {sus_name}.",
                    f"I'm still weighing it, {sender_name}, but {sus_name} worries me.",
                ]
            else:
                pool = [f"Let's see how the votes land in {phase}."]
        elif kind == "suspicion":
            accused_me = _accused_me(me, bot, text)
            investigations = {
                k: v for k, v in (me.get("investigated_alignments") or {}).items()
            }
            if accused_me and investigations:
                k, v = sorted(investigations.items())[h % len(investigations)]
                pool = [
                    f"Wrong target, {sender_name}. I checked {self._name(players, k)} — they read as {v}.",
                    f"I've been doing the work: {self._name(players, k)} came back {v}. I'm not your problem.",
                ]
            elif accused_me:
                fallen = f"{len(dead)} of us are already gone" if dead else "nobody's fallen yet"
                pool = [
                    f"Bold claim, {sender_name} — {fallen} and you point at me? Where's the proof?",
                    f"I'm not the one you should worry about, {sender_name}. Watch {sus_name or 'the quiet ones'}.",
                ]
            elif sus_name:
                pool = [
                    f"I've had my eye on {sus_name} too.",
                    f"{sus_name} has been too quiet for my taste.",
                    f"Interesting theory, {sender_name} — but {sus_name} fits better.",
                ]
            else:
                pool = [f"Accusations need proof, {sender_name}."]
        elif kind == "advice":
            # counsel the SENDER (the vote intent states the bot's own
            # choice); grounded in who the host is waiting on + the bot's
            # suspect read — the determinized slice of the reference bot's
            # free strategic banter (agent/game_agent_v2.py:385-416)
            up = self._advice_up(sender_id, snapshot)
            if up and sus_name:
                pool = [
                    f"You're up, {sender_name} — if it were me, I'd look hard at {sus_name}.",
                    f"It's your move, {sender_name}. My read: {sus_name}.",
                    f"The table's waiting on you. I'd weigh {sus_name} carefully.",
                ]
            elif sus_name:
                pool = [
                    f"When your moment comes, keep your eye on {sus_name}.",
                    f"My advice, {sender_name}: play {phase} straight and watch {sus_name}.",
                ]
            else:
                pool = [
                    f"Play {phase} straight and keep your options open, {sender_name}.",
                    f"No tricks in {phase}, {sender_name} — just don't get read.",
                ]
        elif kind == "rules":
            rt = self._rules_text(text, snapshot)
            if rt and re.search(r"\bwin\b", text, re.IGNORECASE):
                pool = [f"How you win: {rt}",
                        f"The long game, {sender_name}: {rt}"]
            elif rt:
                pool = [f"{phase}: {rt}",
                        f"Here's {phase}, {sender_name}: {rt}"]
            else:
                pool = [
                    f"We're in {phase} — play it as it comes.",
                    f"The game will show you, {sender_name}; right now it's {phase}.",
                ]
        elif kind == "history":
            ht = self._history_text(snapshot)
            fallen = _fallen_board(players, dead)
            if ht:
                pool = [f"The story so far: {ht}",
                        f"Catching you up, {sender_name}: {ht}"]
            elif dead:
                pool = [
                    f"So far we've lost {fallen} — and now it's {phase}.",
                    f"The short of it: {fallen} fallen, {len(alive)} of us left in {phase}.",
                ]
            else:
                pool = [
                    f"Nothing to recap yet — everyone's standing and we're in {phase}.",
                    f"Quiet so far, {sender_name}: no one's fallen and it's {phase}.",
                ]
        else:
            # no intent matched: quote the bot's own (public) standing
            # instead of a contentless deflection
            board = _facts_board(players, bot, self.visibility)
            if board:
                pool = [
                    f"Where I stand, {sender_name}: {board} — and we're in {phase}.",
                    f"For the record ({phase}): {board}.",
                    f"Here's my sheet, {sender_name}: {board}. Your move.",
                ]
            else:
                pool = [
                    f"Noted, {sender_name}. Back to {phase}.",
                    f"Let's focus — we're in {phase}.",
                    f"We'll see soon enough, {sender_name}.",
                ]
        return pool[h % len(pool)]
