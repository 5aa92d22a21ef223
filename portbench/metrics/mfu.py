"""mfu: the policy net's operations that the traced train steps needed
(yardstick.train_step_flops: the unroll's forwards and each epoch's
forward and backward; recomputation not counted) over the traced part's span (the
profiler's range around those steps, opened and closed after a
synchronise), against the bf16 peak, in %."""

from portbench import yardstick


def read(cell, run):
    t = run.traced
    if run.trace is None or not t.get("steps"):
        return None
    d = yardstick.net_dims(cell.config)
    p = cell.config["ppo"]
    flops = t["steps"] * yardstick.train_step_flops(d, t["rooms"], p["horizon"], p["epochs"])
    return yardstick.share(flops / yardstick.PEAK_BF16_FLOPS, run.trace.window_s, "mfu")
