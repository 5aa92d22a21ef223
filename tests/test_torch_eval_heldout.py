"""The port's held-out generator evaluation (utils/eval_heldout.py) against
the JAX package's script on the same fixture, and against the committed
record docs/heldout_eval_r5.json: 8 items, pick_acc 1.0, compile_rate 1.0,
termination_rate 1.0, mean_coverage 0.456. Rows are compared whole."""

import contextlib
import io
import json
import os

import pytest

from game_engine_tpu.utils import eval_heldout as JE
from game_engine_tpu_torch.utils import eval_heldout as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def items():
    with open(E.FIXTURE, encoding="utf-8") as f:
        return json.load(f)["items"]


@pytest.fixture(scope="module")
def port_out(items):
    return E.evaluate(items)


def test_fixture_is_the_jax_scripts(items):
    assert os.path.samefile(E.FIXTURE, JE.FIXTURE)
    assert len(items) == 8


def test_rows_equal_the_jax_script(items, port_out):
    want = [JE.evaluate_item(it) for it in items]
    assert port_out["rows"] == want


def test_summary_equals_the_committed_record(port_out):
    with open(os.path.join(REPO, "docs", "heldout_eval_r5.json"), encoding="utf-8") as f:
        record = json.load(f)
    assert port_out == record
    s = port_out["summary"]
    assert (s["n"], s["pick_acc"], s["compile_rate"], s["termination_rate"],
            s["mean_coverage"]) == (8, 1.0, 1.0, 1.0, 0.456)


def test_main_prints_and_writes_the_result(tmp_path, port_out):
    path = str(tmp_path / "heldout.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = E.main(["--out", path])
    assert out == port_out
    assert json.loads(buf.getvalue()) == port_out
    with open(path, encoding="utf-8") as f:
        assert json.load(f) == port_out
