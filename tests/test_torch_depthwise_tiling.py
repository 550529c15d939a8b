"""A CPU rehearsal of the depthwise kernels' tile plan (B3 / B4,
``chexpert_tpu_torch/csrc/depthwise_{common.cuh,fwd.cu,bwd.cu}``).

A card-less host cannot build the kernels, so this file models, in torch,
what they do with each index: ``plan`` is ``dw::plan`` line by line, with
its constants read from the header; ``stage`` copies a tile's rows into a
model of shared memory as the kernels' 16-byte chunks do (from the aligned
address at or below each row's first element, given the tensor's address
modulo 16), zero-fills the chunks outside the map and zeroes the columns of
copied chunks that fall outside it (``dw::finish``); ``run`` then computes
each thread's items from that model (reading every row at its own offset)
and B4's dw partial
rows (each row group's items, then the row groups, per plane). Memory around the
tensor holds NaN, and unwritten shared memory too, so a read that the
staging does not cover shows in the result.

Held: every output written once, every dw term counted once (an output's g
used once as its own, and zero outside the map), every partial row written
once, and y, dx, dw equal to ``depthwise_{fwd,bwd}_plain`` within 1e-6 of
their largest value in f32 (sums of the same f32 terms in another order),
over the ten stride-1 geometries of efficientnet-b4 at 380x380 with the
batch and channels cut, and ragged shapes, for both element sizes (f32:
4-element chunks; bf16: 8) and misaligned tensor starts.
"""

import re

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops.depthwise import KERNEL_SIZES, depthwise_bwd_plain, depthwise_fwd_plain

COMMON = (kernels.CSRC_DIR / "depthwise_common.cuh").read_text()


_CONSTS: dict = {}


def _const(name: str) -> int:
    """A constexpr int of the header: literals and integer arithmetic of the
    constants read before it."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", COMMON)
    _CONSTS[name] = int(eval(m.group(1).replace("/", "//"), {}, dict(_CONSTS)))
    return _CONSTS[name]


MAX_THREADS, R, CW = _const("MAX_THREADS"), _const("R"), _const("CW")
MAX_TW, TILE_BYTES = _const("MAX_TW"), _const("TILE_BYTES")
MAX_IT, ROWTAB_BYTES = _const("MAX_IT"), _const("ROWTAB_BYTES")
FWD_MIN_IT, BWD_MIN_IT = _const("FWD_MIN_IT"), _const("BWD_MIN_IT")
TARGET_BLOCKS, PLANE_PAD, MAX_C = _const("TARGET_BLOCKS"), _const("PLANE_PAD"), _const("MAX_C")


def cdiv(a, b):
    return -(-a // b)


def pitch_of(tw, p, vec):
    return cdiv(tw + 2 * p, vec) * vec + vec


def plan(B, C, H, W, k, min_it=BWD_MIN_IT):
    """dw::plan: the tile plan of x (B, C, H, W) with an odd k for threads
    of at least min_it row groups (B3: FWD_MIN_IT, B4: BWD_MIN_IT), or None."""
    if min(B, C, H, W, k) < 1 or C > MAX_C or k % 2 == 0:
        return None
    p = k // 2
    ncg_full = cdiv(W, CW)
    n_ct = cdiv(ncg_full, MAX_TW // CW)
    ncg = cdiv(ncg_full, n_ct)
    tw = ncg * CW
    row_bytes = pitch_of(tw, p, 4) * 4
    rows_max = (TILE_BYTES - PLANE_PAD) // row_bytes
    tr_max = MAX_THREADS // ncg
    nrg_max = min((rows_max - 2 * p) // R, tr_max * MAX_IT)
    if nrg_max < 1:
        return None
    nrg_full = cdiv(H, R)
    n_rt = cdiv(nrg_full, nrg_max)
    nrg = cdiv(nrg_full, n_rt)
    th = nrg * R
    it = cdiv(nrg, tr_max)
    if it < min_it and nrg % min_it == 0:
        it = min_it
    tr = cdiv(nrg, it)
    g = 1
    if n_rt == 1 and n_ct == 1:
        plane_max = TILE_BYTES // ((th + 2 * p) * row_bytes + PLANE_PAD)
        g = max(1, min(MAX_THREADS // (tr * ncg), plane_max, C))
        g = cdiv(C, cdiv(C, g))
    n_cg = cdiv(C, g)
    tpc = B * n_rt * n_ct
    nt = min(max(1, tpc * n_cg // TARGET_BLOCKS), tpc)
    s = cdiv(tpc, nt)
    return dict(p=p, ncg=ncg, nrg=nrg, tr=tr, it=it, tw=tw, th=th, n_ct=n_ct, n_rt=n_rt, g=g,
                n_cg=n_cg, threads=cdiv(g * tr * ncg, 32) * 32, tpc=tpc, nt=cdiv(tpc, s), s=s)


def plane_stride(pl, es):
    """dw::plane_stride: a plane's rows, padded so that the stride in bytes is
    the width of its column groups (rounded up to 16) modulo PLANE_PAD."""
    rows = (pl["th"] + 2 * pl["p"]) * pitch_of(pl["tw"], pl["p"], 16 // es)
    target = cdiv(pl["ncg"] * CW * es, 16) * 16 % PLANE_PAD
    return rows + (target - rows * es) % PLANE_PAD // es


def tile_elems(pl, es):
    return pl["g"] * plane_stride(pl, es)


class Memory:
    """A tensor in device memory: its elements at flat positions
    [lead, lead + n) of a buffer whose first element sits at a 256-byte
    boundary, NaN around it."""

    def __init__(self, t, lead, es):
        self.lead, self.es = lead, es
        self.buf = torch.full((lead + t.numel() + 64,), float("nan"))
        self.buf[lead:lead + t.numel()] = t.reshape(-1)

    def off(self, e):  # dw::off_of: element e's position inside its 16-byte chunk
        return ((self.lead + e) * self.es % 16) // self.es


def tile_of(u, cg, pl):
    ct, u = u % pl["n_ct"], u // pl["n_ct"]
    return dict(b=u // pl["n_rt"], cg=cg, i0=(u % pl["n_rt"]) * pl["th"], j0=ct * pl["tw"])


def row_elem(t, g, rr, pl, C, H, W):
    return (((t["b"] * C + t["cg"] * pl["g"] + g) * H * W + (t["i0"] - pl["p"] + rr) * W)
            + t["j0"] - pl["p"])


def stage(mem, pl, C, H, W, t, vec):
    """dw::stage for one operand: the shared tile (rows, pitch), NaN where
    nothing was written."""
    p, pitch = pl["p"], pitch_of(pl["tw"], pl["p"], vec)
    rows_pp = pl["th"] + 2 * p
    rows = pl["g"] * rows_pp
    c0 = t["j0"] - p
    lo, hi = max(c0, 0), min(t["j0"] + pl["tw"] + p, W)
    sm = torch.full((rows, pitch), float("nan"))
    sr = torch.arange(rows)
    g, rr = sr // rows_pp, sr % rows_pp
    ii = t["i0"] - p + rr
    row_in = (t["cg"] * pl["g"] + g < C) & (ii >= 0) & (ii < H)
    e0 = torch.tensor([row_elem(t, int(a), int(b), pl, C, H, W) for a, b in zip(g, rr)])
    off = mem.off(e0)
    s = torch.arange(pitch)
    col = c0 - off[:, None] + (s // vec * vec)[None, :]  # each chunk's first map column
    copied = row_in[:, None] & (col + vec > lo) & (col < hi)
    src = (mem.lead + e0 - off)[:, None] + s[None, :]
    assert bool((src[copied] >= 0).all()), "a chunk starts before the buffer"
    sm[copied] = mem.buf[src[copied]]
    sm[~copied] = 0.0
    left, right, span = lo - c0, hi - c0, pl["tw"] + 2 * p
    for r in sr[row_in].tolist():  # dw::finish: map columns outside [lo, hi)
        o = int(off[r])
        sm[r, o:o + left] = 0.0
        sm[r, o + right:o + span] = 0.0
    return sm, off


def tile_view(sm, off, pl, vec):
    """What the kernel reads: row sr at its offset, tile columns [0, TW + 2p)."""
    span = pl["tw"] + 2 * pl["p"]
    idx = off[:, None] + torch.arange(span)[None, :]
    assert bool((idx < sm.shape[1]).all())
    return sm.gather(1, idx).view(pl["g"], pl["th"] + 2 * pl["p"], span)


def items(pl, cg, C):
    """dw::item_of for every thread of a block (column group first, then
    plane, then thread row rg0), and the thread's items: row groups rg0,
    rg0 + tr, ... below nrg. Returns per item (thread, g, rg, cq, c, active)."""
    tid = torch.arange(pl["threads"])
    rest, cq = tid // pl["ncg"], tid % pl["ncg"]
    rg0, g = rest // pl["g"], rest % pl["g"]
    c = cg * pl["g"] + g
    j = torch.arange(pl["it"])
    rg = (rg0[:, None] + j[None, :] * pl["tr"]).reshape(-1)
    thread = tid[:, None].expand(-1, pl["it"]).reshape(-1)
    g, cq, c = g[thread], cq[thread], c[thread]
    active = (rg0[thread] < pl["tr"]) & (rg < pl["nrg"]) & (c < C)
    return thread, g, rg.clamp(max=pl["nrg"] - 1), cq, c, active


def conv_items(A, w_items, g, rg, cq, k):
    """Each item's R x CW outputs from the tile view A (G, TH + 2p, TW + 2p)
    with its channel's weights w_items (items, k, k)."""
    o, q = torch.arange(R), torch.arange(CW)
    out = torch.zeros(len(g), R, CW)
    for dy in range(k):
        for e in range(k):
            rows = (rg[:, None] * R + o[None, :] + dy)[:, :, None]
            cols = (cq[:, None] * CW + q[None, :] + e)[:, None, :]
            out += w_items[:, dy, e, None, None] * A[g[:, None, None], rows, cols]
    return out


def scatter(out, written, vals, t, g, rg, cq, c, active, H, W):
    """Store each active item's outputs inside the map, counting the writes."""
    o, q = torch.arange(R), torch.arange(CW)
    i = (t["i0"] + rg[:, None] * R + o[None, :])[:, :, None].expand(-1, R, CW)
    j = (t["j0"] + cq[:, None] * CW + q[None, :])[:, None, :].expand(-1, R, CW)
    m = active[:, None, None] & (i < H) & (j < W)
    cc = c[:, None, None].expand(-1, R, CW)
    idx = (torch.full_like(cc[m], t["b"]), cc[m], i[m], j[m])
    out[idx] = vals[m]
    written.index_put_(idx, torch.ones(int(m.sum())), accumulate=True)


def run(x, w, gy, es, leads, min_it):
    """One plan on CPU tensors: (y, dx, dw, write counts) as B3 (min_it =
    FWD_MIN_IT: take y) and B4 (BWD_MIN_IT: take dx, dw) compute them, for
    element size es (f32 4, bf16 2)."""
    B, C, H, W = x.shape
    k = w.shape[-1]
    pl, vec, p = plan(B, C, H, W, k, min_it), 16 // es, k // 2
    assert plane_stride(pl, es) >= (pl["th"] + 2 * p) * pitch_of(pl["tw"], p, vec)
    assert plane_stride(pl, es) * es % 16 == 0
    assert tile_elems(pl, es) * es <= TILE_BYTES
    assert tile_elems(pl, 4) * 4 <= TILE_BYTES and pl["threads"] <= MAX_THREADS
    assert pl["g"] * (pl["th"] + 2 * p) * 8 <= ROWTAB_BYTES and pl["nrg"] <= pl["tr"] * pl["it"]
    mx, mg = Memory(x, leads[0], es), Memory(gy, leads[1], es)
    wf = w.view(C, k, k)
    y, dx = torch.full(x.shape, float("nan")), torch.full(x.shape, float("nan"))
    y_n, dx_n = torch.zeros(x.shape), torch.zeros(x.shape)
    own_g = torch.zeros(x.shape)  # times an output's g served as an item's own
    part = torch.full((pl["s"], C, k * k), float("nan"))
    part_n = torch.zeros(pl["s"], C, k * k)
    for cg in range(pl["n_cg"]):
        thread, g, rg, cq, c, active = items(pl, cg, C)
        w_items = wf[c.clamp(max=C - 1)]
        for blk in range(pl["s"]):  # B4's blocks walk nt tiles; B3 has one block per tile
            dwacc = torch.zeros(len(g), k, k)  # per item; each thread sums its items
            for u in range(blk * pl["nt"], min(blk * pl["nt"] + pl["nt"], pl["tpc"])):
                t = tile_of(u, cg, pl)
                X = tile_view(*stage(mx, pl, C, H, W, t, vec), pl, vec)
                G = tile_view(*stage(mg, pl, C, H, W, t, vec), pl, vec)
                scatter(y, y_n, conv_items(X, w_items, g, rg, cq, k), t, g, rg, cq, c, active,
                        H, W)
                scatter(dx, dx_n, conv_items(G, w_items.flip(1, 2), g, rg, cq, k), t, g, rg,
                        cq, c, active, H, W)
                o, q = torch.arange(R), torch.arange(CW)
                rows = (rg[:, None] * R + o[None, :] + p)[:, :, None]
                cols = (cq[:, None] * CW + q[None, :] + p)[:, None, :]
                gc = torch.where(active[:, None, None], G[g[:, None, None], rows, cols], 0.0)
                i = (t["i0"] + rg[:, None] * R + o[None, :])[:, :, None].expand(-1, R, CW)
                j = (t["j0"] + cq[:, None] * CW + q[None, :])[:, None, :].expand(-1, R, CW)
                inside = active[:, None, None] & (i < H) & (j < W)
                assert bool((gc[~inside] == 0).all()), "an own g outside the map is not zero"
                cc = c[:, None, None].expand(-1, R, CW)
                own_g.index_put_((torch.full_like(cc[inside], t["b"]), cc[inside], i[inside], j[inside]),
                                 torch.ones(int(inside.sum())), accumulate=True)
                for dy in range(k):
                    for e in range(k):
                        dwacc[:, dy, e] += (X[g[:, None, None], rows - p + dy, cols - p + e]
                                            * gc).sum((1, 2))
            # the block's reduction: each thread's items, then each thread row's
            # ncg threads (consecutive) of a plane, then the plane's thread rows
            vals = torch.zeros(pl["threads"], k * k).index_add_(0, thread,
                                                                dwacc.view(-1, k * k))
            ncg = pl["ncg"]
            for pg in range(pl["g"]):
                ch = cg * pl["g"] + pg
                if ch >= C:
                    continue
                runs = [vals[(rt * pl["g"] + pg) * ncg:(rt * pl["g"] + pg + 1) * ncg].sum(0)
                        for rt in range(pl["tr"])]
                part[blk, ch] = torch.stack(runs).sum(0)
                part_n[blk, ch] += 1
    return y, dx, part.sum(0).view(C, 1, k, k), (y_n, dx_n, own_g, part_n)


B4_380 = [  # (H = W, C, k) of efficientnet-b4's stride-1 depthwise layers at 380x380
    (190, 48, 3), (190, 24, 3), (95, 192, 3), (48, 336, 5), (24, 672, 3), (24, 672, 5),
    (24, 960, 5), (12, 1632, 5), (12, 1632, 3), (12, 2688, 3)]
def _g(H, C, k, min_it=BWD_MIN_IT):
    """The planes a tile groups at efficientnet-b4's training batch."""
    return plan(16, C, H, H, k, min_it)["g"]


# the ten geometries with the batch and the channels cut: where B4's plan
# groups planes, C is a multiple of its G at the full layer (B3 groups as many
# of them as it can)
CASES = (
    [pytest.param(1, 2, 190, 190, 3, id="b4_190_c48"), pytest.param(2, 1, 190, 190, 3, id="b4_190_c24"),
     pytest.param(1, 3, 95, 95, 3, id="b4_95"), pytest.param(2, 2, 48, 48, 5, id="b4_48"),
     pytest.param(2, 2 * _g(24, 672, 3), 24, 24, 3, id="b4_24_k3"),
     pytest.param(1, _g(24, 672, 5), 24, 24, 5, id="b4_24_k5"),
     pytest.param(1, 3 * _g(24, 960, 5), 24, 24, 5, id="b4_24_c960"),
     pytest.param(1, _g(12, 1632, 5), 12, 12, 5, id="b4_12_k5"),
     pytest.param(2, _g(12, 1632, 3), 12, 12, 3, id="b4_12_k3"),
     pytest.param(1, 2 * _g(12, 2688, 3), 12, 12, 3, id="b4_12_c2688")]
    # ragged: odd W, H below one band, C = G +- 1, 1x1 maps, k = 1 and 9, wide rows
    + [pytest.param(*s, id=f"ragged_{i}") for i, s in enumerate(
        [(2, 3, 7, 9, 3), (1, 2, 3, 301, 5), (2, _g(12, 1632, 5) + 1, 12, 12, 5),
         (1, _g(12, 1632, 3, FWD_MIN_IT) - 1, 12, 12, 3), (3, 5, 1, 1, 3), (2, 4, 1, 1, 9),
         (2, 3, 10, 10, 1), (1, 2, 13, 11, 9), (1, 2, 6, 6, 7), (2, 15, 5, 3, 5),
         (1, 8, 24, 24, 3)])]
)


def test_cases_cover_the_b4_geometries_and_their_plans():
    """The cut cases keep each b4 geometry's (H, W, k) and, where B4's plan
    groups planes, its G at the full channel count (B3's groups planes too)."""
    ids = {p.id: p.values for p in CASES}
    for H, C, k in B4_380:
        cut = [v for n, v in ids.items() if n.startswith(f"b4_{H}") and v[4] == k]
        assert cut, (H, C, k)
        full = plan(16, C, H, H, k, BWD_MIN_IT)["g"]
        assert any(plan(*v, BWD_MIN_IT)["g"] == full for v in cut), (H, C, k)
        if full > 1:  # B3's tiles group planes there too
            assert all(plan(*v, FWD_MIN_IT)["g"] > 1 for v in cut), (H, C, k)
    assert plan(4, 1632, 12, 12, 5)["g"] > 1 and plan(4, 672, 24, 24, 3)["g"] > 1
    assert plan(16, 48, 190, 190, 3)["g"] == 1 and plan(16, 48, 190, 190, 3)["tw"] >= 190


@pytest.mark.parametrize("es,leads", [(4, (0, 0)), (4, (1, 3)), (2, (0, 0)), (2, (5, 2))],
                         ids=["f32", "f32_misaligned", "bf16", "bf16_misaligned"])
@pytest.mark.parametrize("B,C,H,W,k", CASES)
def test_tile_plan_covers_every_output_once_and_equals_plain(B, C, H, W, k, es, leads):
    gen = torch.Generator().manual_seed(B * 1000 + C * 10 + k)
    x = torch.randn(B, C, H, W, generator=gen)
    w = torch.randn(C, 1, k, k, generator=gen) * 0.2
    gy = torch.randn(B, C, H, W, generator=gen)
    y, _, _, (y_n, _, _, _) = run(x, w, gy, es, leads, FWD_MIN_IT)
    _, dx, dw, (_, dx_n, own_g, part_n) = run(x, w, gy, es, leads, BWD_MIN_IT)
    for name, n in (("y", y_n), ("dx", dx_n), ("own g", own_g)):
        assert bool((n == 1).all()), f"{name} written {n.min()}..{n.max()} times"
    assert bool((part_n == 1).all())
    dx_p, dw_p = depthwise_bwd_plain(x, w, gy)
    for got, want in ((y, depthwise_fwd_plain(x, w)), (dx, dx_p), (dw, dw_p)):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_plan_takes_every_instantiated_k_and_refuses_the_rest():
    for k in KERNEL_SIZES:
        pl = plan(16, 2688, 12, 12, k)
        assert pl is not None and pl["threads"] <= MAX_THREADS
        assert tile_elems(pl, 4) * 4 <= TILE_BYTES and tile_elems(pl, 2) * 2 <= TILE_BYTES
    assert plan(1, 1, 8, 8, 2) is None and plan(1, MAX_C + 1, 8, 8, 3) is None
    assert plan(0, 1, 8, 8, 3) is None
