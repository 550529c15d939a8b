"""Bounds of the attention kernels: frozen copies of ``chip_smoke.py``'s
``bound``, ``split_bound``, ``bound_sum``, ``b1_bound``, ``b2_bounds``,
``b5_bound`` and ``b6_bounds``, with the exp rate at the fixed 1980 MHz
clock (the card's clock, read at run time, would move the yardstick), and
``step_bound``: the attention of one training step of a configuration."""

from __future__ import annotations

from bounds.peaks import ELEMENT_BYTES, EXPS_PER_S, HBM_BYTES_PER_S, PEAK_FLOPS

_BOUND_PARTS = {"bytes_ms": "bytes", "ops_ms": "operations", "exp_ms": "exp"}


def _bound_of(parts: dict) -> dict:
    key = max(_BOUND_PARTS, key=lambda k: parts[k])  # ties go to the first: bytes
    return {**parts, "bound_ms": parts[key], "bound_by": _BOUND_PARTS[key]}


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0) -> dict:
    """The least time of a call: its bytes over the memory rate, its
    operations over the peak rate of their type, its exps over the special
    function units' rate; the largest binds."""
    return {"bytes": nbytes, "flops": flops, "exps": exps, **_bound_of({
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "ops_ms": flops / PEAK_FLOPS[dtype] * 1e3,
        "exp_ms": exps / EXPS_PER_S * 1e3})}


def bound_sum(terms) -> dict:
    """terms = (count, bound of one call): each part summed, the largest binds."""
    terms = list(terms)
    return _bound_of({k: sum(n * b[k] for n, b in terms) for k in _BOUND_PARTS})


def b1_bound(bn: int, H: int, W: int, dvh: int, dtype: str, dkh: int) -> dict:
    """Head-major forward at bn slices: qr, k, v read and out, lse written
    once; per (query, key) pair q.k 2 dkh, the two relative terms 2, max and
    sum 2, p.v 2 dvh, and one exp."""
    hw, L = H * W, dkh + W + H
    pairs = bn * hw * hw
    es = ELEMENT_BYTES[dtype]
    return bound(bn * hw * (L + dkh + 2 * dvh) * es + bn * hw * 4,
                 pairs * (2 * dkh + 4 + 2 * dvh), dtype, pairs)


def split_bound(parts: dict, dtype: str) -> dict:
    """parts = {pass: (bytes, flops, exps)}: each pass's share, and the whole
    function ("whole") from the summed shares."""
    nbytes, flops, exps = (sum(p[i] for p in parts.values()) for i in range(3))
    return {**{k: bound(b, f, dtype, e) for k, (b, f, e) in parts.items()},
            "whole": bound(nbytes, flops, dtype, exps)}


def b2_bounds(bn: int, H: int, W: int, dvh: int, dtype: str, dkh: int) -> dict:
    """Head-major backward as one function of (qr, k, v, out, lse, dout):
    each read once, dqr, dk, dv written once; per pair S 2 dkh + 2, dp and dv
    4 dvh, ds 2, dk and dq 4 dkh, the two bins 2, one exp."""
    hw, L = H * W, dkh + W + H
    pairs, es = bn * hw * hw, ELEMENT_BYTES[dtype]
    ins = bn * hw * (L + dkh + 3 * dvh) * es + bn * hw * 4
    return split_bound({
        "dkdv": (ins + bn * hw * (dkh + dvh) * es, pairs * (4 * dkh + 4 * dvh + 4), pairs),
        "dq": (bn * hw * L * es, pairs * (2 * dkh + 2), 0)}, dtype)


def b5_bound(B: int, nh: int, H: int, W: int, dvh: int, slot: int, dtype: str,
             dkh: int) -> dict:
    """Heads-in-lanes forward over the packed operand: P, Rw, Rh read, out and
    lse written once; per pair B1's operations, per query the RC rows 2 dkh
    (W + H); one exp per pair."""
    hw, tok = H * W, B * nh * H * W
    es = ELEMENT_BYTES[dtype]
    rel_bytes = (W * W + H * H) * dkh * 4
    return bound(B * hw * nh * slot * es + rel_bytes + B * hw * nh * dvh * es + tok * 4,
                 tok * hw * (2 * dkh + 4 + 2 * dvh) + tok * (W + H) * 2 * dkh, dtype, tok * hw)


def b6_bounds(B: int, nh: int, H: int, W: int, dvh: int, slot: int, dtype: str,
              dkh: int) -> dict:
    """Heads-in-lanes backward as one function of (P, Rw, Rh, out, lse,
    dout): each read once, dP, dRw and dRh written once; per pair B2's
    operations and one exp, per query the RC rows, their gradient and dq's
    relative part 6 dkh (W + H)."""
    hw, tok = H * W, B * nh * H * W
    pairs, es = tok * hw, ELEMENT_BYTES[dtype]
    P_bytes, rel_bytes = B * hw * nh * slot * es, (W * W + H * H) * dkh * 4
    ins = P_bytes + 2 * tok * dvh * es + tok * 4 + rel_bytes
    return split_bound({
        "dq": (ins + P_bytes * dkh / slot,
               pairs * (4 * dkh + 2 * dvh + 6) + tok * (W + H) * 4 * dkh, pairs),
        "dkdv": (P_bytes * (slot - dkh) / slot, pairs * (2 * dkh + 2 * dvh), 0),
        "drel": (rel_bytes, tok * (W + H) * 2 * dkh, 0)}, dtype)


def layer_bounds_ms(layer: dict, batch: int, layout: str, dtype: str = "bf16"):
    """(forward, backward) bound in ms of one AA layer's attention call at
    ``batch`` images: B1 and the whole B2 for ``bn``; B5 and the whole B6 for
    ``hil`` over the tight slot 2 dkh + dvh (the configuration's widths, no
    padding lanes)."""
    H, W = layer["map"]
    nh = layer["nh"]
    dkh, dvh = layer["dk"] // nh, layer["dv"] // nh
    if layout == "bn":
        return (b1_bound(batch * nh, H, W, dvh, dtype, dkh)["bound_ms"],
                b2_bounds(batch * nh, H, W, dvh, dtype, dkh)["whole"]["bound_ms"])
    if layout == "hil":
        slot = 2 * dkh + dvh
        return (b5_bound(batch, nh, H, W, dvh, slot, dtype, dkh)["bound_ms"],
                b6_bounds(batch, nh, H, W, dvh, slot, dtype, dkh)["whole"]["bound_ms"])
    raise ValueError(f"layout {layout!r}")


def step_bound_ms(aa_layers, batch: int, layout: str, dtype: str = "bf16") -> float:
    """The attention of one training step: every AA layer's forward and
    backward call, each at its own bound, summed (the calls run in turn)."""
    return sum(n * sum(layer_bounds_ms(layer, batch, layout, dtype)) for n, layer in aa_layers)
