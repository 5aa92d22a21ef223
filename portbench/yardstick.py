"""The benchmark's frozen yardstick: the card's peaks, the policy net's
multiply-adds, the least time a piece of work could take, and the shares
of a peak that the per-layer metrics report.

Nothing here reads the card or the program: the peaks are NVIDIA's
published figures, and the net's sizes and the interpreter's operations
come from the configuration files, counted once (see count_ops.py). A
share above 100% means that the work was counted too high or the time
left part of it out; it raises, and is never clipped.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data
# sheet; dense rates, without sparsity), at the card's full power limit of
# 700 W. A run records the limit it ran under beside every share.
PEAK_BF16_FLOPS = 989e12   # bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12   # HBM3, bytes/s
# int32 rate: 132 SMs x 64 INT32 lanes an SM x 1,980 MHz boost clock (the
# Hopper architecture white paper), fixed here and never read from the card
SMS, INT32_LANES_PER_SM, BOOST_HZ = 132, 64, 1980e6
PEAK_INT32_OPS = SMS * INT32_LANES_PER_SM * BOOST_HZ


def net_dims(config: dict):
    """The policy net's dims as the configuration file freezes them."""
    from portbench.reference.policy import Dims

    return Dims(**config["net_dims"])


def policy_macs(d) -> tuple:
    """(forward, backward) multiply-adds a row of the policy net at dims d:
    every product of the forward, and of the backward with no gradient for
    the observation."""
    P, F0, hp, H, L, no, T = d.P, d.F0, d.hp, d.hidden, d.layers, d.n_opt, d.trunk_in
    a = 1 if d.has_attn else 0
    heads = H * (hp + no + 1)
    trunk = T * H + (L - 1) * H * H
    enc = P * hp * hp + a * (P * hp * 3 * hp + P * hp * hp)  # w_phi1, w_qkv, w_ao
    fwd = P * F0 * hp + enc + a * 2 * P * P * hp + trunk + heads + P * hp
    bwd = (P * F0 * hp + enc + trunk + heads) + (enc + trunk + heads) \
        + a * 4 * P * P * hp + 2 * P * hp
    return fwd, bwd


def bound_s(flops: float, nbytes: float) -> tuple:
    """(least seconds the card could take, "operations" or "bytes"): the
    larger of the bf16 operations over the tensor-core peak and the bytes
    over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def n_params(d) -> int:
    """The policy net's parameter count at dims d."""
    hp, H, L = d.hp, d.hidden, d.layers
    enc = d.F0 * hp + hp + hp * hp + hp + (2 * hp + 3 * hp * hp + hp * hp if d.has_attn else 0)
    trunk = d.trunk_in * H + H + (L - 1) * (H * H + H)
    return enc + H * hp + trunk + H * d.n_opt + d.n_opt + H + 1


def k4_bound_s(d, rows: int) -> tuple:
    """K4's least time over `rows` rows: the forward and backward products,
    or the bytes read once (the bf16 rows, the f32 per-row inputs of width
    2A + 5, the f32 parameters) and written once (the f32 gradient)."""
    fwd, bwd = policy_macs(d)
    nbytes = rows * (2 * d.F + 4 * (2 * d.A + 5)) + 2 * 4 * n_params(d)
    return bound_s(2 * (fwd + bwd) * rows, nbytes)


def train_step_flops(d, rooms: int, horizon: int, epochs: int) -> float:
    """The policy net's operations that one PPO step needs: the unroll's
    horizon + 1 forwards of rooms x P rows (the last is the bootstrap
    value), and each epoch's forward and backward over the horizon's rows.
    Recomputation is not counted."""
    fwd, bwd = policy_macs(d)
    rows = rooms * d.P
    return 2.0 * (fwd * rows * (horizon + 1) + epochs * (fwd + bwd) * rows * horizon)


def k1_bound_s(ops_per_room_step: float, room_steps: int) -> float:
    """K1's least time: the interpreter's integer operations over the int32 rate."""
    return ops_per_room_step * room_steps / PEAK_INT32_OPS


def share(least_s: float, measured_s: float, what: str) -> float:
    """least_s / measured_s in %; raises above 100%."""
    if measured_s <= 0:
        raise ValueError(f"{what}: no measured time ({measured_s} s)")
    pct = 100.0 * least_s / measured_s
    if pct > 100.0:
        raise ValueError(f"{what} reads {pct:.3f}% of its peak: the work is counted too "
                         f"high or the time leaves out part of it")
    return pct


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of (start, end) intervals."""
    busy, at = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, at), min(b, hi)
        if b > a:
            busy += b - a
            at = b
    return busy


def idle_share(intervals, lo: float, hi: float) -> float:
    """The share of [lo, hi], in %, in which no interval runs."""
    if hi <= lo:
        raise ValueError("an empty traced window")
    return 100.0 * (1.0 - union_s(intervals, lo, hi) / (hi - lo))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of values, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    i = int(pos)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)

