"""idle_share: the share of the traced part of the window in which no
operation ran on the card (1 - the union of the device operations'
intervals over the traced span), from torch.profiler's trace."""


from portbench.yardstick import idle_share


def read(cell, run):
    t = run.trace
    if t is None:
        return None
    return idle_share([(a, b) for _, a, b in t.device_ops], t.lo, t.hi)
