"""The harness finds a cell's parts by name from data files, prints the
contract's last line, and refuses to run without a card."""

import json
import os
import shutil

import pytest
import torch

from portbench import harness, run, spec


def test_every_cell_is_found_from_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.chips == w["chips"] and cell.config["name"] == w["config"]
        assert hasattr(spec.load_module("drivers", cell.traffic), "run")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "env_steps_per_s"}
        assert cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))


def test_a_new_cell_needs_only_new_files(tmp_path):
    here = tmp_path / "portbench"
    for sub in ("configs", "workloads"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    new = dict(json.loads((here / "workloads" / "werewolf8.rollout.json").read_text()),
               rooms=4096, why="the north-star shape")
    (here / "workloads" / "werewolf8.rollout-4096.json").write_text(json.dumps(new))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "werewolf8.rollout-4096", "config": "werewolf8",
                               "traffic": "rollout", "chips": 1, "why": "north star"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("werewolf8.rollout-4096", root=str(tmp_path), here=str(here))
    assert cell.workload["rooms"] == 4096 and cell.traffic == "rollout"
    # metrics without a workloads key reach it; listed ones do not
    assert "idle_share" in {m["name"] for m in cell.per_layer}
    assert "call_ms_p95" not in {m["name"] for m in cell.end_to_end}


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    here = tmp_path / "portbench"
    for sub in ("configs", "workloads"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    bad = json.loads((here / "workloads" / "werewolf8.train.json").read_text())
    bad["traffic"] = "rollout"
    (here / "workloads" / "werewolf8.train.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        spec.cell("werewolf8.train", here=str(here))


def _run(trace: bool) -> harness.Run:
    tr = harness.Trace([("ge_rollout_kernel<1>", 0.1, 0.9)], 0.0, 1.0, []) if trace else None
    return harness.Run(setup_s=1.5, window_s=2.0, work=1000, attempted=10, failed=0,
                       memory_peak_bytes=123, checks=[harness.Check("x_gap", 0.0, 0.1)],
                       calls_ms=[float(i) for i in range(1, 11)], trace=tr,
                       traced={"calls": 1})


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    cell = spec.cell("werewolf8.rollout")
    line = harness.result_line(cell, _run(trace), trace, "NVIDIA H100 80GB HBM3, 700.00 W")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        assert line["device"]["busy_s"] == pytest.approx(0.8)
        assert line["device"]["window_s"] == pytest.approx(1.0)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) == want  # k1_roofline and idle_share
    else:
        assert set(line["metrics"]) == want
        assert line["metrics"]["env_steps_per_s"]["value"] == 500.0
    json.dumps(line)


def test_a_failed_check_makes_the_line_incorrect(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "card")
    r = _run(False)
    r.checks.append(harness.Check("words_differing", 1, 0))
    r.checks.append(harness.Check("nan_gap", float("nan"), 1.0))
    line = harness.result_line(spec.cell("werewolf8.rollout"), r, False, "card")
    assert line["correct"] is False


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "werewolf8.rollout", "--seed", str(2 ** 31 + 7),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_fewer_cards_than_the_cell_asks_for_exit_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "werewolf8.train", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_room_seeds_take_large_seeds_and_repeat():
    a = harness.room_seeds(2 ** 31 + 12345, 64)
    assert a.dtype.name == "uint32" and (a == harness.room_seeds(2 ** 31 + 12345, 64)).all()
    assert not (a == harness.room_seeds(2 ** 31 + 12346, 64)).all()
    assert harness.stream_seed(2 ** 40, 1) != harness.stream_seed(2 ** 40, 0)
