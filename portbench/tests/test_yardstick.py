"""The frozen yardstick: peaks, operation counts, shares and the trace's
arithmetic, on the CPU."""

import json
import math

import pytest

from portbench import harness, spec, yardstick
from portbench.reference import lower_game
from portbench.reference.policy import dims_for, param_shapes


def test_peaks_are_the_published_figures():
    assert yardstick.PEAK_BF16_FLOPS == 989e12
    assert yardstick.PEAK_HBM_BYTES == 3.35e12
    assert yardstick.PEAK_INT32_OPS == pytest.approx(16.727e12, rel=1e-4)


def test_frozen_net_dims_are_the_games():
    cfg = spec.cell("werewolf8.train").config
    net = cfg["net"]
    d = dims_for(lower_game(cfg["game_file"]), net["hidden"], net["layers"], net["arch"])
    assert yardstick.net_dims(cfg) == d


def test_param_count_matches_the_shapes():
    d = yardstick.net_dims(spec.cell("werewolf8.train").config)
    assert yardstick.n_params(d) == sum(math.prod(s) for s in param_shapes(d).values())
    assert yardstick.n_params(d) == 254338  # the port's fused._n_params at this tree


def test_policy_macs_at_the_attn_net():
    d = yardstick.net_dims(spec.cell("werewolf8.train").config)
    fwd, bwd = yardstick.policy_macs(d)
    # hand count: phi0 8*17*128, phi1 8*128*128, qkv 8*128*384, ao 8*128*128,
    # scores 2*8*8*128, trunk 275*256 + 256*256, heads 256*(128+1+1), pointer 8*128
    enc = 8 * 128 * 128 + 8 * 128 * 384 + 8 * 128 * 128
    trunk = 275 * 256 + 256 * 256
    heads = 256 * 130
    assert fwd == 8 * 17 * 128 + enc + 2 * 8 * 8 * 128 + trunk + heads + 8 * 128
    assert bwd == (8 * 17 * 128 + enc + trunk + heads) + (enc + trunk + heads) \
        + 4 * 8 * 8 * 128 + 2 * 8 * 128


def test_train_step_flops_counts_unroll_and_epochs():
    d = yardstick.net_dims(spec.cell("werewolf8.train").config)
    fwd, bwd = yardstick.policy_macs(d)
    rows = 4096 * 8
    assert yardstick.train_step_flops(d, 4096, 32, 4) == 2.0 * (
        fwd * rows * 33 + 4 * (fwd + bwd) * rows * 32)


def test_bounds_take_the_larger_side():
    t, side = yardstick.bound_s(989e12, 1.0)
    assert (t, side) == (1.0, "operations")
    t, side = yardstick.bound_s(1.0, 3.35e12 * 2)
    assert (t, side) == (2.0, "bytes")
    d = yardstick.net_dims(spec.cell("werewolf8.train").config)
    t, side = yardstick.k4_bound_s(d, 1 << 20)
    assert side == "operations" and t > 0


def test_share_raises_above_100_and_never_clips():
    assert yardstick.share(1.0, 2.0, "x") == 50.0
    assert yardstick.share(2.0, 2.0, "x") == 100.0
    with pytest.raises(ValueError, match="too high"):
        yardstick.share(2.1, 2.0, "k4_roofline")
    with pytest.raises(ValueError):
        yardstick.share(1.0, 0.0, "mfu")


def test_k1_bound_uses_the_frozen_rate():
    assert yardstick.k1_bound_s(151.0, 1_000_000) == pytest.approx(
        151e6 / (132 * 64 * 1980e6))


@pytest.mark.parametrize("workload", ["werewolf8.rollout", "two-truths8.rollout"])
def test_ops_per_room_step_is_frozen_with_its_origin(workload):
    ops = spec.cell(workload).config["ops_per_room_step"]
    assert ops["value"] > 0 and ops["min"] <= ops["value"] <= ops["max"]
    assert len(ops["commit"]) == 40 and ops["seeds"] == "0-11"


def test_union_and_idle_share_on_overlaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert yardstick.union_s(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert yardstick.idle_share(iv, 0.0, 10.0) == pytest.approx(60.0)
    with pytest.raises(ValueError):
        yardstick.idle_share(iv, 1.0, 1.0)


def test_percentile_is_numpys_linear_one():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == pytest.approx(95.05)
    assert yardstick.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def _chrome(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events]}


def test_trace_idle_share_and_breakdown_on_a_synthetic_trace(tmp_path):
    us = 1e6
    events = [
        {"cat": "user_annotation", "name": harness.TRACED, "ts": 0, "dur": 10 * us},
        {"cat": "kernel", "name": "ge_rollout_kernel<1>", "ts": 1 * us, "dur": 3 * us},
        {"cat": "kernel", "name": "ge_rollout_kernel<1>", "ts": 2 * us, "dur": 3 * us},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 6 * us, "dur": 1 * us},
        {"cat": "kernel", "name": "outside", "ts": 11 * us, "dur": 1 * us},
        {"cat": "cpu_op", "name": "aten::item", "ts": 5 * us, "dur": 1 * us},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 7.5 * us, "dur": 2 * us},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_chrome(events)))
    t = harness.read_trace(str(path))
    assert (t.lo, t.hi) == (0.0, 10.0)
    assert t.busy_s() == pytest.approx(5.0)    # [1, 5] and [6, 7]
    assert t.window_s == pytest.approx(10.0)
    assert t.gaps() == [(0.0, 1.0), (5.0, 6.0), (7.0, 10.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["ge_rollout_kernel<1>", pytest.approx(6.0)]
    assert [g[0] for g in b["idle_gaps"]] == [
        "aten::copy_", "host code outside any traced operation", "aten::item"]
    assert len(t.ops(lambda n: "ge_rollout_kernel" in n)) == 2


def test_trace_without_its_range_is_refused(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_chrome([{"cat": "kernel", "name": "k", "ts": 0, "dur": 1}])))
    with pytest.raises(RuntimeError):
        harness.read_trace(str(path))


def test_k4_calls_are_runs_with_a_weight_gradient():
    k4 = spec.load_module("metrics", "k4_roofline")
    ops = [("gemm_kernel", 0.0, 1.0), ("each_kernel<F>", 1.0, 1.5),       # a K2 forward
           ("ob_sample_kernel", 1.5, 1.6),
           ("each_kernel<F>", 2.0, 2.1), ("gemm_kernel", 2.1, 3.0),         # a K4 call
           ("wgrad_kernel", 3.0, 4.0), ("reduce_kernel", 4.0, 4.2),
           ("void multi_tensor_apply_kernel", 4.3, 4.4),
           ("gemm_kernel", 5.0, 6.0), ("wgrad_kernel", 6.0, 7.0)]           # another
    t = harness.Trace(ops, 0.0, 10.0, [])
    assert k4.calls(t) == pytest.approx([2.2, 2.0])


def _k4_run(steps):
    ops = []
    for c in range(4):  # four K4 calls, each split from the next by Adam's kernel
        t = 10.0 * c
        ops += [("gemm_kernel", t, t + 1.0), ("wgrad_kernel", t + 1.0, t + 2.0),
                ("multi_tensor_apply_kernel", t + 2.0, t + 2.1)]
    return harness.Run(setup_s=1.0, window_s=1.0, work=1, attempted=1, failed=0,
                       memory_peak_bytes=1, checks=[], trace=harness.Trace(ops, 0.0, 40.0, []),
                       traced={"steps": steps, "rooms": 4096})


def test_k4_roofline_counts_the_traced_steps_calls():
    k4 = spec.load_module("metrics", "k4_roofline")
    cell = spec.cell("werewolf8.train")
    assert cell.config["ppo"]["epochs"] == 4
    d = yardstick.net_dims(cell.config)
    least, _ = yardstick.k4_bound_s(d, cell.config["ppo"]["horizon"] * 4096 * d.P)
    assert k4.read(cell, _k4_run(1)) == pytest.approx(100 * least * 4 / 8.0)


def test_k4_roofline_refuses_runs_that_are_not_one_a_call():
    k4 = spec.load_module("metrics", "k4_roofline")
    with pytest.raises(ValueError):
        k4.read(spec.cell("werewolf8.train"), _k4_run(2))
