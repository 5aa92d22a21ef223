"""k1_roofline: K1's least time over its device time in the traced part of
the window, in %. The least time is the configuration's frozen count of
the interpreter's integer operations a room-step (count_ops.py) times the
room-steps of the traced calls (the driver's count of them x rooms x
steps a call), over the fixed int32 rate (yardstick.PEAK_INT32_OPS); the
device time is the sum of the kernels named K1_KERNEL in the traced part,
however many launches a call makes."""

from portbench import yardstick

K1_KERNEL = "ge_rollout_kernel"


def read(cell, run):
    if run.trace is None or not run.traced.get("calls"):
        return None
    ops = run.trace.ops(lambda name: K1_KERNEL in name)
    if not ops:
        return None
    w = cell.workload
    room_steps = run.traced["calls"] * int(w["rooms"]) * int(w["steps_per_call"])
    least = yardstick.k1_bound_s(cell.config["ops_per_room_step"]["value"], room_steps)
    return yardstick.share(least, sum(b - a for _, a, b in ops), "k1_roofline")
