"""StateLayout: map the DSL's per-player state schema onto fixed-shape arrays.

The reference keeps player_states as free-form dicts synced over CopilotKit
(reference: src/lib/canvas/types.ts:342). For a jittable struct-of-arrays
state we lower every declared field to a typed slot:

  boolean  -> bool bank   (B, P, n_bool)
  num      -> int32 bank  (B, P, n_num)
  string   -> int32 categorical bank (B, P, n_str) with a per-field vocab
              (vocab mined from roles, players_example values, and string
              literals in audience criteria; id 0 is reserved for ''/unknown)
  dict     -> two shapes:
              * player-keyed categorical (e.g. investigated_alignments:
                {"2": "villagers"}) -> (B, P, P) int32 matrix slot
              * opaque small-indexed (e.g. statements: {"1": "text"}) ->
                (B, P, DICT_W) int32 mark-slots (contents are cosmetic
                strings; the FSM only tracks which keys are set)
  array    -> (B, P, ARR_W) int32 + implicit zero-fill

Names are cosmetic (projection synthesizes "Player N"), so a string field
called ``name`` lowers to a categorical with the player's own index.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from portbench.reference.gamespec.schema import Declaration, FieldSpec, FieldType

DICT_W = 8  # opaque dict key slots per player
ARR_W = 8  # array element slots per player

BANK_BOOL = "bool"
BANK_NUM = "num"
BANK_STR = "str"
BANK_PDICT = "pdict"  # player-keyed dict matrix
BANK_ODICT = "odict"  # opaque dict mark-slots
BANK_ARR = "arr"


@dataclasses.dataclass(frozen=True)
class Slot:
    field: str
    bank: str
    index: int  # position within the bank
    vocab: tuple[str, ...] = ()  # for BANK_STR / BANK_PDICT values
    default: Any = None

    def encode(self, value: Any) -> int:
        """Encode a raw scalar value to the slot's int representation."""
        if self.bank == BANK_BOOL:
            return 1 if value else 0
        if self.bank == BANK_NUM:
            try:
                return int(value)
            except (TypeError, ValueError):
                return 0
        if self.bank in (BANK_STR, BANK_PDICT):
            s = str(value) if value is not None else ""
            sl = s.lower()
            for i, v in enumerate(self.vocab):
                if v.lower() == sl:
                    return i
            return 0
        raise TypeError(f"encode() not defined for bank {self.bank}")

    def decode(self, code: int) -> Any:
        if self.bank == BANK_BOOL:
            return bool(code)
        if self.bank == BANK_NUM:
            return int(code)
        if self.bank in (BANK_STR, BANK_PDICT):
            if 0 <= code < len(self.vocab):
                return self.vocab[code]
            return ""
        raise TypeError(f"decode() not defined for bank {self.bank}")


def _string_vocab(decl: Declaration, field: FieldSpec) -> list[str]:
    """Mine the closed vocabulary for a string field. Index 0 = ''/unset."""
    vocab: list[str] = [""]

    def add(v: Any) -> None:
        if isinstance(v, str) and v and v.lower() not in [x.lower() for x in vocab]:
            vocab.append(v)

    if field.name == "role":
        for r in decl.roles:
            add(r.name)
    add(field.example)
    # the template default MUST be encodable — `reset field` restores it,
    # and a doc shipped without players_example still has to round-trip
    # every literal its programs compare or write
    add(field.default)
    for row in decl.players_example.values():
        add(row.get(field.name))
    # literals from audience criteria that mention this field
    for g in decl.audience_groups:
        if re.search(rf"\b{re.escape(field.name)}\b", g.selection_criteria):
            for m in re.findall(r"'([^']+)'|\"([^\"]+)\"", g.selection_criteria):
                add(m[0] or m[1])
    return vocab


def _dict_value_vocab(decl: Declaration, field: FieldSpec) -> list[str]:
    vocab: list[str] = [""]

    def add(v) -> None:
        # case-insensitive dedup, matching Slot.encode's case-insensitive
        # lookup (two case variants would make the second unreachable)
        if isinstance(v, str) and v and v.lower() not in [x.lower() for x in vocab]:
            vocab.append(v)

    ex = field.example if isinstance(field.example, dict) else {}
    for v in ex.values():
        add(v)
    for row in decl.players_example.values():
        rv = row.get(field.name)
        if isinstance(rv, dict):
            for v in rv.values():
                add(v)
    return vocab


def _is_player_keyed(field: FieldSpec, decl: Declaration) -> bool:
    """Dict keys look like player ids and values come from a small vocab."""
    samples: list[dict] = []
    if isinstance(field.example, dict):
        samples.append(field.example)
    for row in decl.players_example.values():
        v = row.get(field.name)
        if isinstance(v, dict):
            samples.append(v)
    keys = [k for d in samples for k in d]
    if not keys:
        # fall back to the description: "mapping player IDs ..."
        return bool(re.search(r"player\s*id", field.description, re.IGNORECASE))
    try:
        ids = [int(str(k)) for k in keys]
    except ValueError:
        return False
    # player ids are small positive ints; statement keys 1..3 also qualify
    # numerically, so additionally require single-word vocab values
    # (team/alignment words) — any multi-word value means free text
    # (statements, notes), which must stay an opaque mark-slot bank.
    vals = [v for d in samples for v in d.values()]
    free_text = any(isinstance(v, str) and len(v.split()) > 1 for v in vals)
    return all(1 <= i <= 64 for i in ids) and not free_text


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Slot assignment for every declared field."""

    slots: dict[str, Slot]
    n_bool: int
    n_num: int
    n_str: int
    n_pdict: int
    n_odict: int
    n_arr: int

    def slot(self, field: str) -> Slot:
        return self.slots[field]

    def get(self, field: str) -> Optional[Slot]:
        return self.slots.get(field)

    def bool_index(self, field: str) -> int:
        s = self.slots[field]
        assert s.bank == BANK_BOOL, field
        return s.index

    def num_index(self, field: str) -> int:
        s = self.slots[field]
        assert s.bank == BANK_NUM, field
        return s.index


def build_layout(decl: Declaration) -> StateLayout:
    slots: dict[str, Slot] = {}
    counts = {BANK_BOOL: 0, BANK_NUM: 0, BANK_STR: 0, BANK_PDICT: 0, BANK_ODICT: 0, BANK_ARR: 0}

    def alloc(field: FieldSpec, bank: str, vocab: tuple[str, ...] = ()) -> None:
        slots[field.name] = Slot(
            field=field.name, bank=bank, index=counts[bank], vocab=vocab, default=field.default
        )
        counts[bank] += 1

    for f in decl.fields:
        if f.type is FieldType.BOOLEAN:
            alloc(f, BANK_BOOL)
        elif f.type is FieldType.NUM:
            alloc(f, BANK_NUM)
        elif f.type is FieldType.STRING:
            alloc(f, BANK_STR, tuple(_string_vocab(decl, f)))
        elif f.type is FieldType.DICT:
            if _is_player_keyed(f, decl):
                alloc(f, BANK_PDICT, tuple(_dict_value_vocab(decl, f)))
            else:
                alloc(f, BANK_ODICT)
        elif f.type is FieldType.ARRAY:
            alloc(f, BANK_ARR)

    return StateLayout(
        slots=slots,
        n_bool=max(counts[BANK_BOOL], 1),
        n_num=max(counts[BANK_NUM], 1),
        n_str=max(counts[BANK_STR], 1),
        n_pdict=max(counts[BANK_PDICT], 1),
        n_odict=max(counts[BANK_ODICT], 1),
        n_arr=max(counts[BANK_ARR], 1),
    )
