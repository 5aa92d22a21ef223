"""k4_roofline: K4's least time over its device time in the traced part of
the window, in %. The traced train steps make steps x epochs K4 calls (the
driver's count of steps, the configuration's epochs); the least time of a
call over the whole trajectory (horizon x rooms x seats rows) is the larger
of its products at the bf16 peak and its bytes at the memory rate
(yardstick.k4_bound_s). K4's device time is that of the runs of consecutive
lossgrad.cu kernels (LG_KERNELS) that hold a weight-gradient product
(K4_MARK); K2's forward-only runs hold none. Where the runs found are not
one a call (another operation inside a call splits it, or a call's
kernels are renamed), the reading would be wrong, so it raises."""

from portbench import yardstick

LG_KERNELS = ("gemm_kernel", "wgrad_kernel", "colsum_kernel", "reduce_kernel", "each_kernel")
K4_MARK = "wgrad_kernel"


def calls(trace) -> list:
    """Each K4 call's device seconds."""
    out, run, marked = [], [], False
    for name, a, b in sorted(trace.ops(lambda n: True), key=lambda op: op[1]):
        if any(k in name for k in LG_KERNELS):
            run.append(b - a)
            marked = marked or K4_MARK in name
            continue
        if run and marked:
            out.append(sum(run))
        run, marked = [], False
    if run and marked:
        out.append(sum(run))
    return out


def read(cell, run):
    if run.trace is None or not run.traced.get("steps"):
        return None
    p = cell.config["ppo"]
    n_calls = run.traced["steps"] * p["epochs"]
    k4 = calls(run.trace)
    if len(k4) != n_calls:
        raise ValueError(f"k4_roofline: {len(k4)} runs of K4's kernels in the trace of "
                         f"{run.traced['steps']} steps x {p['epochs']} epochs = {n_calls} calls")
    d = yardstick.net_dims(cell.config)
    rows = p["horizon"] * int(cell.workload["rooms"]) * d.P
    least, _ = yardstick.k4_bound_s(d, rows)
    return yardstick.share(least * n_calls, sum(k4), "k4_roofline")
