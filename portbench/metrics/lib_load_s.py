"""lib_load_s: the seconds this process spent making the program's CUDA
libraries ready, by the program's own record (_build.libs_ready: each
library found or built in build/kernels/, then loaded): the union of the
record's (start, end) spans, so libraries built at once count once, read
in the traced run: near 0 on a warm checkout, the builds on a checkout's
first run. Nothing where the program keeps no record."""

from portbench.yardstick import union_s


def read(cell, run):
    from game_engine_tpu_torch import _build

    libs = getattr(_build, "libs_ready", None)
    if run.trace is None or libs is None:
        return None
    return union_s([s for rec in libs for s in rec["spans"]], float("-inf"), float("inf"))
