"""The port's probe evaluation (game_engine_tpu_torch/utils/eval_chat_probes.py)
on the CPU: the rooms it builds equal the JAX script's, the composer tier
passes all 24 probes of tests/fixtures/chat_probes.json, and the product
paths with the shipped chat LM (student_fb, sampled_fb) pass three of them
through the port's hook (the plain decode; the kernel runs them on the card
in chip_smoke.py)."""

import json
import os

import pytest

from game_engine_tpu.utils import eval_chat_probes as JE
from game_engine_tpu_torch.policies.chat_lm import make_lm_hook
from game_engine_tpu_torch.utils import eval_chat_probes as E
from tests.test_torch_net import one_torch_thread  # noqa: F401

# small tensors in loops: one intra-op thread, as the other port tests
pytestmark = pytest.mark.usefixtures("one_torch_thread")

LM_PROBES = ("ww_alive_other", "ww_role_direct", "ww_dead_recap")


@pytest.fixture(scope="module")
def data():
    with open(E.FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def rooms(data):
    return E.load_rooms(data)


def test_rooms_equal_the_jax_scripts(data, rooms):
    for r in data["rooms"]:
        snap, vis, _, room = rooms[r["game"]]
        jsnap, jvis, _, jroom = JE.build_room_snapshot(r["game"], r["n_players"], r["seed"],
                                                       r["steps"])
        assert snap == jsnap and vis == jvis
        assert not room.done and room.phase.dsl_id == jroom.phase.dsl_id


def test_composer_tier_passes_every_probe(data, rooms):
    out = E.evaluate(rooms, data["probes"], {"composer": None})["tiers"]["composer"]
    assert out["n"] == 24 and out["ok_rate"] == 1.0 and out["failures"] == []
    assert out["classified_rate"] == 1.0 and out["lm_served"] == 0
    jax_rooms = {r["game"]: JE.build_room_snapshot(r["game"], r["n_players"], r["seed"],
                                                   r["steps"]) for r in data["rooms"]}
    for probe in data["probes"]:
        assert E.run_probe(probe, rooms, None) == JE.run_probe(probe, jax_rooms, None)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["student_fb", "sampled_fb"])
def test_lm_tiers_pass_three_probes(data, rooms, temp, one_torch_thread):
    hook = make_lm_hook(E._CKPT, sample_temp=temp, device="cpu")
    probes = [p for p in data["probes"] if p["id"] in LM_PROBES]
    out = E.evaluate(rooms, probes, {"lm": hook})["tiers"]["lm"]
    assert out["n"] == 3 and out["ok_rate"] == 1.0, out["failures"]
    assert out["lm_served"] == 3


def test_main_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    path = str(tmp_path / "out.json")
    out = E.main(["--no-lm", "--device", "cpu", "--out", path])
    with open(path) as f:
        assert json.load(f) == out
    assert set(out) == {"fixture", "tiers"} and set(out["tiers"]) == {"composer"}
    with open(os.path.join(os.path.dirname(E.FIXTURE), "..", "..", "docs",
                           "chat_probe_eval_r5.json")) as f:
        rec = json.load(f)
    assert set(out["tiers"]["composer"]) == set(rec["tiers"]["composer"])
