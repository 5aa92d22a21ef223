"""The port's copy of the DSL generator and validator
(game_engine_tpu_torch/dslgen/) against the JAX package's: the same
validation issues for every catalog game and for generated documents, the
same generated document and report for the catalog's own descriptions and
tests/test_dslgen.py's, the same compile-explain; and
tests/test_server_dslgen.py's HTTP drive on the port's torch host."""

import os
import shutil
import threading

import pytest
import yaml

import tests.test_dslgen as TD
from game_engine_tpu.dslgen import explain as JE
from game_engine_tpu.dslgen import generate as JG
from game_engine_tpu.dslgen import validate as JV
from game_engine_tpu.gamespec.parser import load_game_spec as jax_load_game_spec
from game_engine_tpu_torch.dslgen import explain as E
from game_engine_tpu_torch.dslgen import generate as G
from game_engine_tpu_torch.dslgen import validate as V
from game_engine_tpu_torch.gamespec.parser import games_dir, load_game_spec
from game_engine_tpu_torch.server.api import make_server
from tests.test_server import req
from tests.test_torch_net import one_torch_thread  # noqa: F401

CATALOG = sorted(fn for fn in os.listdir(games_dir()) if fn.endswith(".yaml"))
# tests/test_dslgen.py's named descriptions, and a few of its inline ones
DESCRIPTIONS = sorted(
    [(name.strip("_").lower(), value) for name, value in vars(TD).items()
     if name.endswith("_DESC") and isinstance(value, str)]
    + [("storytime", "A turn-based storytelling guessing party game."),
       ("poker-night", "poker night, five-card bluffing with chips, flop and river"),
       ("shadow-council", "A hidden-role night elimination deduction game where "
                          "assassins secretly kill.")])


def _strs(issues):
    return [str(i) for i in issues]


@pytest.mark.parametrize("fn", CATALOG)
def test_catalog_validates_and_explains_as_in_jax(fn):
    path = os.path.join(games_dir(), fn)
    spec, jspec = load_game_spec(path), jax_load_game_spec(path)
    assert _strs(V.validate_spec(spec)) == _strs(JV.validate_spec(jspec))
    assert not V.errors(V.validate_spec(spec))
    with open(path) as f:
        doc = yaml.safe_load(f)
    issues, vspec = V.validate_doc(doc, name=spec.name)
    jissues, _ = JV.validate_doc(yaml.safe_load(open(path)), name=spec.name)
    assert _strs(issues) == _strs(jissues) and vspec is not None
    assert E.explain_spec(spec) == JE.explain_spec(jspec)


@pytest.mark.parametrize("fn", CATALOG)
def test_catalog_descriptions_generate_as_in_jax(fn):
    with open(os.path.join(games_dir(), fn)) as f:
        decl = yaml.safe_load(f)["declaration"]
    name = os.path.splitext(fn)[0]
    rep, jrep = [], []
    doc = G.generate_from_description(name, decl.get("description", ""), report=rep)
    assert doc == JG.generate_from_description(name, decl.get("description", ""), report=jrep)
    assert rep == jrep


@pytest.mark.parametrize("name,desc", DESCRIPTIONS, ids=[n for n, _ in DESCRIPTIONS])
def test_described_games_generate_and_validate_as_in_jax(name, desc):
    rep, jrep = [], []
    doc = G.generate_from_description(name, desc, report=rep)
    jdoc = JG.generate_from_description(name, desc, report=jrep)
    assert doc == jdoc and rep == jrep
    issues, spec = V.validate_doc(doc, name=name)
    jissues, _ = JV.validate_doc(jdoc, name=name)
    assert _strs(issues) == _strs(jissues)
    assert spec is not None and not V.errors(issues)


def test_validator_catches_structural_errors():
    issues, spec = V.validate_doc({"declaration": {}, "phases": []}, name="bad")
    assert V.errors(issues)
    assert _strs(issues) == _strs(JV.validate_doc({"declaration": {}, "phases": []},
                                                  name="bad")[0])


@pytest.fixture()
def server(tmp_path):
    gdir = tmp_path / "games"
    shutil.copytree(games_dir(), gdir)
    srv = make_server(port=0, games_path=str(gdir), device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


def test_generate_dsl_and_play(server):
    code, data = req(server, "POST", "/api/generate-dsl",
                     {"gameName": "Shadow Council",
                      "gameDescription": "A hidden-role night elimination deduction game "
                                         "where assassins secretly kill."})
    assert code == 200, data
    assert data["name"] == "shadow-council" and "declaration" in data["yaml"]
    code, cat = req(server, "GET", "/api/games")
    assert "shadow-council" in [g["name"] for g in cat["games"]]
    code, d = req(server, "POST", "/api/rooms/create",
                  {"gameName": "shadow-council", "playerName": "Gen"})
    assert code == 200, d
    room_id = d["room"]["roomId"]
    req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    code, snap = req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 4})
    assert code == 200, snap
    for _ in range(60):
        code, snap = req(server, "POST", f"/api/rooms/{room_id}/continue")
        if snap["done"]:
            break
        req(server, "POST", f"/api/rooms/{room_id}/vote", {"playerId": 1, "option": 1})
    assert snap["done"] and snap["winner"] >= 1
    code, notes = req(server, "GET", f"/api/rooms/{room_id}/notes")
    assert code == 200
    assert {"phase", "win"} <= {n["type"] for n in notes["game_notes"]}


def test_generate_dsl_requires_name_and_never_clobbers(server):
    assert req(server, "POST", "/api/generate-dsl", {"gameName": "///"})[0] == 400
    body = {"gameName": "Two Truths and a Lie",
            "gameDescription": "statements, truths and lies, guess the lie each round"}
    code, data = req(server, "POST", "/api/generate-dsl", body)
    assert code == 409 and "already exists" in data["error"]
    code, data = req(server, "POST", "/api/generate-dsl", {**body, "overwrite": True})
    assert code == 200 and data["name"] == "two-truths-and-a-lie"


def test_generate_dsl_warns_on_low_coverage(server):
    code, data = req(server, "POST", "/api/generate-dsl",
                     {"gameName": "Poker Night",
                      "gameDescription": "poker night, five-card bluffing "
                                         "with chips, flop and river"})
    assert code == 200, data
    warns = " | ".join(data["warnings"])
    assert "description coverage" in warns and "does NOT match" in warns


def test_explain_routes(server):
    code, data = req(server, "GET", "/api/games/werewolf/explain")
    assert code == 200 and data == JE.explain_spec(jax_load_game_spec(
        os.path.join(games_dir(), "werewolf-(mafia).yaml")))
    assert req(server, "GET", "/api/games/no-such-game/explain")[0] == 404
    with open(os.path.join(games_dir(), "tide-pool.yaml")) as f:
        text = f.read()
    code, data = req(server, "POST", "/api/explain", {"yaml": text, "gameName": "draft"})
    assert code == 200 and data["errors"] == [] and "explain" in data
    code, data = req(server, "POST", "/api/explain", {"yaml": "not: [valid"})
    assert code == 422


def test_generate_dsl_bad_model_falls_back_loudly(tmp_path):
    gdir = tmp_path / "games"
    shutil.copytree(games_dir(), gdir)
    srv = make_server(port=0, games_path=str(gdir), llm_cmd="echo 'not: [valid'",
                      device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, data = req(srv, "POST", "/api/generate-dsl",
                         {"gameName": "Garble",
                          "gameDescription": "a hidden-role night elimination deduction game"})
        assert code == 200, data
        assert any("model output rejected" in w for w in data["warnings"])
    finally:
        srv.shutdown()
