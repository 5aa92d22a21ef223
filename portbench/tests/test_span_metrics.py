"""The readers of the program's spans and record (card_wait_ms,
dispatch_ms, lib_load_s) on hand-made traces: (name, start s, end s) of
the card's operations and of the host's, the program's spans among the
latter."""

import json

import pytest

from portbench import harness, spans, spec


def _read(metric: str, run):
    return spec.load_module("metrics", metric).read(spec.cell("werewolf8.rollout"), run)


def _run(device, host, traced=None, lo=0.0, hi=10.0):
    trace = harness.Trace(device, lo, hi, host)
    return harness.Run(setup_s=1.0, window_s=10.0, work=1, attempted=1, failed=0,
                       memory_peak_bytes=0, checks=[], trace=trace,
                       traced={"calls": 1} if traced is None else traced)


BUSY = [("k", 0.0, 1.0), ("k", 2.0, 10.0)]  # the card idles in [1, 2] alone


def test_a_gap_outside_every_span_does_not_count():
    run = _run(BUSY, [("aten::copy_", 0.5, 2.5), ("ge.entry.K1", 3.0, 4.0)])
    assert _read("card_wait_ms", run) == 0.0
    assert _read("dispatch_ms", run) == pytest.approx(1000.0)


def test_a_gap_inside_a_span_counts_its_overlap():
    run = _run(BUSY, [("ge.entry.K1", 1.5, 4.0)])
    assert _read("card_wait_ms", run) == pytest.approx(500.0)


def test_nested_spans_are_not_counted_twice():
    host = [("ge.train_step", 0.0, 10.0), ("ge.unroll", 0.5, 3.0), ("ge.entry.OB", 1.0, 1.8),
            ("ge.entry.K2", 1.2, 2.5), ("ge.K1.launch", 1.3, 1.4)]
    run = _run(BUSY, host)
    assert _read("card_wait_ms", run) == pytest.approx(1000.0)
    assert _read("dispatch_ms", run) == pytest.approx(1500.0)  # [1.0, 2.5]


def test_a_span_over_a_busy_card_reads_zero():
    run = _run([("k", 0.0, 10.0)], [("ge.train_step", 1.0, 9.0), ("ge.entry.K4", 2.0, 3.0)])
    assert _read("card_wait_ms", run) == 0.0


@pytest.mark.parametrize("traced", [{"calls": 4}, {"steps": 4, "rooms": 8}])
def test_the_readers_divide_by_the_traced_calls_or_steps(traced):
    run = _run(BUSY, [("ge.entry.K1", 0.0, 4.0)], traced)
    assert _read("card_wait_ms", run) == pytest.approx(1000.0 / 4)
    assert _read("dispatch_ms", run) == pytest.approx(4000.0 / 4)


def test_spans_are_clipped_to_the_traced_part():
    run = _run(BUSY, [("ge.entry.K1", -5.0, 1.5)])
    assert _read("dispatch_ms", run) == pytest.approx(1500.0)
    assert _read("card_wait_ms", run) == pytest.approx(500.0)


@pytest.mark.parametrize("metric", ["card_wait_ms", "dispatch_ms", "lib_load_s"])
def test_each_reader_reads_nothing_without_a_trace(metric):
    run = _run(BUSY, [("ge.entry.K1", 0.0, 4.0)])
    run.trace = None
    assert _read(metric, run) is None


@pytest.mark.parametrize("metric", ["card_wait_ms", "dispatch_ms"])
def test_a_program_without_spans_leaves_them_unread(monkeypatch, metric):
    from game_engine_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "span")
    assert _read(metric, _run(BUSY, [])) is None


def test_lib_load_s_takes_the_union_of_the_programs_record(monkeypatch):
    from game_engine_tpu_torch import _build

    monkeypatch.setattr(_build, "libs_ready", [  # two built at once, then each loaded
        {"stem": "librollout", "built": True, "spans": [(0.0, 2.5), (3.0, 3.25)],
         "seconds": 2.75},
        {"stem": "libobserve", "built": True, "spans": [(0.0, 3.0), (3.25, 3.5)],
         "seconds": 3.25}])
    assert _read("lib_load_s", _run(BUSY, [])) == pytest.approx(3.5)
    monkeypatch.delattr(_build, "libs_ready")
    assert _read("lib_load_s", _run(BUSY, [])) is None


def test_the_profilers_start_before_the_first_operation_does_not_count():
    """The first call's host and the card idle behind it, up to the card's
    first operation, are the profiler starting."""
    run = _run([("k", 1.0, 2.0), ("k", 3.0, 10.0)], [("ge.entry.K1", 0.0, 4.0)])
    assert _read("card_wait_ms", run) == pytest.approx(1000.0)  # [2, 3]
    assert _read("dispatch_ms", run) == pytest.approx(3000.0)  # [1, 4]


def test_dispatch_leaves_out_the_cuda_runtime_calls_inside_entries():
    """A launch that blocks on a full queue waits on the card's work."""
    host = [("ge.entry.K4", 0.0, 4.0), ("cudaLaunchKernel", 1.0, 2.5),
            ("cuLaunchKernel", 2.0, 3.0), ("cudaMemcpyAsync", 5.0, 6.0),
            ("aten::copy_", 3.0, 3.5)]
    assert _read("dispatch_ms", _run(BUSY, host)) == pytest.approx(2000.0)


def test_the_split_names_each_gap_by_its_innermost_span():
    host = [("ge.entry.K1", 0.5, 3.0), ("ge.K1.to_minor", 0.8, 1.6), ("aten::copy_", 1.0, 1.2),
            ("cudaLaunchKernel", 2.5, 2.6)]
    out = spans.split(spec.cell("werewolf8.rollout"), _run(BUSY, host, {"calls": 2}))
    assert out["card_wait_ms"] == pytest.approx(500.0)  # [1, 2] inside the entry, a call
    assert out["dispatch_ms"] == pytest.approx(1200.0)  # 2.5 s less 0.1 in the launch
    assert out["spans"]["ge.K1.to_minor"]["card_wait_ms"] == pytest.approx(300.0)
    assert out["spans"]["ge.entry.K1"]["card_wait_ms"] == pytest.approx(200.0)
    assert out["spans"]["ge.entry.K1"]["self_ms"] == pytest.approx(850.0)
    assert out["spans"]["ge.entry.K1"]["runtime_ms"] == pytest.approx(50.0)
    assert out["idle_inside_spans"] == pytest.approx(1.0)
    (gap,) = out["top_gaps"]
    assert gap["span"] == "ge.K1.to_minor"
    assert gap["host_ops"] == ["ge.entry.K1", "ge.K1.to_minor"]


@pytest.mark.parametrize("rc", [0, 2])
def test_spans_main_runs_the_cell_through_run(monkeypatch, capsys, rc):
    """python3 -m portbench.spans runs portbench.run's own main, with
    --trace 1 and the benchmark's run_seconds, and prints the split of the
    run that main printed after its line; where main refuses (no card: 2),
    so does it, and prints nothing more."""
    from portbench import run as bench_run

    cell, seen = spec.cell("werewolf8.rollout"), []
    line = lambda cell, run, trace, card: {"correct": True}  # noqa: E731
    monkeypatch.setattr(harness, "result_line", line)

    def main(argv):
        seen.append(argv)
        if rc == 0:
            harness.result_line(cell, _run(BUSY, [("ge.entry.K1", 1.5, 4.0)]), True, "card")
        return rc

    monkeypatch.setattr(bench_run, "main", main)
    assert spans.main(["--workload", cell.name, "--seed", "3100023999"]) == rc
    assert seen == [["--workload", cell.name, "--seed", "3100023999", "--seconds",
                     str(spec.benchmark()["run_seconds"]), "--trace", "1"]]
    assert harness.result_line is line
    out = capsys.readouterr().out
    if rc:
        assert out == ""
    else:
        assert json.loads(out)["card_wait_ms"] == pytest.approx(500.0)
