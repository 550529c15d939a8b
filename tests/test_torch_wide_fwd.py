"""The tensor-core forward of heads past the largest width class, on the CPU:
the plan that ``ops/fused_attention.py`` chooses for ``csrc/attention_wide.cuh``'s
``fwd_tc_kernel`` (B1 / B5 on bf16 maps up to 64x64), held against the
sources and at every head ``chip_smoke.py`` runs; a torch rehearsal of the
kernel's tile (several (batch, head) pairs packed into one 64-token tile, S
masked to each pair's keys, the online softmax over key tiles) against the
plain forward; and what the source must keep: the RC rows through the one
``rc_rows`` that pass dq calls, no atomics. No compiler and no card: the
kernel itself runs in tests/test_torch_kernels_cuda.py."""

import math
import re

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops import fused_attention as fa
from chexpert_tpu_torch.ops import hil_attention as hil

WIDE = (kernels.CSRC_DIR / "attention_wide.cuh").read_text()

# every head past (128, 64) that chip_smoke.py runs, at its maps: the width
# rows (WIDE_GEOS), BENCH_WRN_WIDER's (320, 160) / (640, 320), resnet 50's
# (512, 256) on 2x2 and 4x4, and the card tests' WIDE_CASES
SMOKE_HEADS = [(16, 16, 160, 64), (8, 8, 320, 128), (8, 8, 150, 75), (1, 1, 512, 256),
               (16, 16, 320, 160), (8, 8, 640, 320), (2, 2, 512, 256), (4, 4, 512, 256),
               (5, 7, 129, 8), (9, 9, 20, 65), (64, 64, 256, 128), (72, 72, 160, 64)]
PAIRS = (512, 256, 4, 1)  # the width rows' batch 256 x 2 heads, the bench's 256 x 1, tests


@pytest.mark.parametrize("pairs", PAIRS)
@pytest.mark.parametrize("H,W,dkh,dvh", SMOKE_HEADS)
def test_forward_plan_fits_one_block(H, W, dkh, dvh, pairs):
    """Every wide head chip_smoke.py runs takes the tensor-core forward where
    its map is on the tensor cores: shared memory within 232,448 bytes a
    block (the query rows, two key and value tiles, the RC rows, the token
    table, as tc_smem counts them), the column groups cover out's n8 tiles
    in groups of at most NTO, warp groups as the backward takes them; a map
    past the tensor cores has no plan (the CUDA-core kernel)."""
    plan = fa.wide_fwd_plan(H, W, dkh, dvh, pairs)
    if not fa.on_tensor_cores(torch.bfloat16, H, W):
        assert plan is None
        assert fa.fwd_plan_args(torch.bfloat16, H, W, dkh, dvh, pairs) == (0,) * 5
        return
    kp, vp = -(-dkh // 16) * 16, -(-dvh // 16) * 16
    rs = fa._rel_stride(W, H)
    smem = (fa.BW_ROWS * (kp + 8) * 2 + fa.BW_ROWS * 16 + 2 * plan["tk"] * (kp + vp + 16) * 2
            + fa.BW_ROWS * rs * 4)
    assert plan["smem"] == smem <= fa.BW_SMEM_MAX
    tiles = -(-dvh // 8)
    assert plan["tiles"] <= fa.BW_NTO and plan["groups"] * plan["tiles"] >= tiles
    assert (plan["groups"] - 1) * plan["tiles"] < tiles
    assert plan["warp_groups"] == (fa.BW_WG if plan["groups"] > 1 else 1)
    assert plan["blocks_per_tile"] * plan["warp_groups"] >= plan["groups"]
    assert plan["tk"] in (16, 32)
    assert fa.fwd_plan_args(torch.bfloat16, H, W, dkh, dvh, pairs) == (
        plan["pack"], plan["groups"], plan["warp_groups"], plan["tk"], plan["smem"])


@pytest.mark.parametrize("H,W,dkh,dvh,groups", [(16, 16, 160, 64, 1), (8, 8, 320, 128, 1),
                                                (8, 8, 150, 75, 1), (1, 1, 512, 256, 1),
                                                (8, 8, 640, 320, 2)])
def test_one_block_forms_s_for_every_column(H, W, dkh, dvh, groups):
    """S and p once per (query tile, key tile) for every column of out: one
    column group up to dvh 256; (640, 320) takes two warp groups of one
    block, which share its staged rows and RC rows."""
    plan = fa.wide_fwd_plan(H, W, dkh, dvh, 512)
    assert plan["groups"] == groups and plan["blocks_per_tile"] == 1


def _blocks(pairs, plan):
    return -(-pairs // plan["pack"]) * plan["own_tiles"] * plan["blocks_per_tile"]


def _resident(plan, sms=fa.H100_SMS):
    return sms * plan["blocks_per_sm"]


@pytest.mark.parametrize("H,W,dkh,dvh,pairs", [
    (1, 1, 512, 256, 512), (2, 2, 512, 256, 512), (4, 4, 256, 128, 512), (4, 4, 512, 256, 512),
    (1, 1, 512, 256, 4096), (2, 2, 160, 64, 8192), (1, 1, 150, 75, 1001), (5, 5, 160, 64, 300),
    (1, 1, 512, 256, 263), (1, 1, 512, 256, 5), (8, 8, 320, 128, 8192), (5, 7, 129, 8, 8192)])
def test_tiny_maps_pack_into_one_wave(H, W, dkh, dvh, pairs):
    """A map of at most 32 tokens packs the fewest (batch, head) pairs a tile
    that let the whole grid be resident at once (132 SMs x the blocks an
    SM's shared memory holds), at most 64 // hw: 1x1 at batch 256 x 2 heads
    packs 4 (128 blocks, one an SM); larger maps and heads a width class
    holds pack 1."""
    plan = fa.wide_fwd_plan(H, W, dkh, dvh, pairs)
    pack = plan["pack"]
    assert pack == fa.fwd_pack(H, W, dkh, dvh, pairs)
    assert fa.fwd_plan_args(torch.bfloat16, H, W, dkh, dvh, pairs)[0] == pack
    if H * W > fa.BW_ROWS // 2:
        assert pack == 1
        return
    assert 1 <= pack <= fa.BW_ROWS // (H * W)
    if pack < fa.BW_ROWS // (H * W):
        assert _blocks(pairs, plan) <= _resident(plan)
    if pack > 1:
        assert -(-pairs // (pack - 1)) > _resident(plan)  # the fewest that fit
    assert fa.fwd_pack(H, W, 128, 64, pairs) == 1


@pytest.mark.parametrize("H,W,dkh,dvh,pairs,pack", [(1, 1, 512, 256, 512, 4),
                                                    (4, 4, 256, 128, 512, 2),
                                                    (1, 1, 512, 256, 132, 1)])
def test_pack_of_the_width_rows(H, W, dkh, dvh, pairs, pack):
    """The width rows' 1x1 (512, 256) at 512 pairs packs 4 (one block an SM;
    scripts/ab_attention_torch.py --packs times it faster than pack 3, two
    waves); 4x4 (256, 128) packs 2 (two blocks an SM)."""
    assert fa.fwd_pack(H, W, dkh, dvh, pairs) == pack


def test_forward_instances_match_the_source():
    """The forward's instances (n8 tiles a warp, blocks an SM its launch
    bounds promise) that the plan counts are the source's FWD_NTG and
    fwd_blocks."""
    ntg = re.search(r"constexpr int FWD_NTG\[4\] = \{([^}]*)\};", WIDE).group(1)
    assert [int(x) for x in ntg.split(",")] == [n for n, _ in fa.FWD_INSTANCES]
    body = re.search(r"constexpr int fwd_blocks\(int ntg\) \{ return ([^;]*); \}", WIDE).group(1)
    expr = re.sub(r"(ntg <= \d+) \? (\d+) :", r"\2 if \1 else", body)  # C++ ?: as Python
    for n, blocks in fa.FWD_INSTANCES:
        assert eval(expr, {"ntg": n}) == blocks  # noqa: S307 - a literal conditional


@pytest.mark.parametrize("H,W,dkh,dvh,pairs,tk", [(8, 8, 150, 75, 512, 16), (8, 8, 150, 75, 1024, 32),
                                                  (16, 16, 160, 64, 512, 32),
                                                  (8, 8, 320, 128, 512, 32)])
def test_forward_takes_16_keys_where_that_makes_one_wave(H, W, dkh, dvh, pairs, tk):
    """tk 16 where the grid is resident at once only at 16 keys a tile:
    (150, 75) on 8x8 at batch 256 x 2 heads, 512 blocks, fits four blocks an
    SM at 16 and three at 32."""
    plan = fa.wide_fwd_plan(H, W, dkh, dvh, pairs)
    assert plan["tk"] == tk
    if tk == 16:
        assert _blocks(pairs, plan) <= _resident(plan)


def test_pack_follows_the_card_it_runs_on():
    """The pack counts the SMs of the card the wrapper runs on (sm_count),
    132 where no card is asked."""
    assert fa.fwd_pack(1, 1, 512, 256, 512, sms=114) == 5
    assert fa.fwd_pack(1, 1, 512, 256, 512) == -(-512 // fa.H100_SMS)


@pytest.mark.parametrize("dkh,dvh", [(20, 4), (64, 32), (128, 64)])
def test_heads_a_class_holds_take_no_forward_plan(dkh, dvh):
    """The classes' forwards take no wide plan: the wrappers pass zeros, as
    they do for f32 and maps past the tensor cores."""
    assert fa.fwd_plan_args(torch.bfloat16, 8, 8, dkh, dvh, 512) == (0,) * 5
    assert fa.fwd_plan_args(torch.float32, 8, 8, 320, 128, 512) == (0,) * 5
    assert fa.fwd_plan_args(torch.bfloat16, 72, 72, 320, 128, 512) == (0,) * 5


def test_rows_too_wide_take_the_cuda_core_forward():
    """A head whose rows do not fit a block even at 16 keys a tile has no
    tensor-core plan."""
    assert fa.wide_fwd_plan(8, 8, 1600, 800, 512) is None
    assert fa.fwd_plan_args(torch.bfloat16, 8, 8, 1600, 800, 512) == (0,) * 5


def _params(text: str, entry: str) -> list:
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("entry", [fa.NAME, hil.FWD])
def test_forward_entries_take_the_plan_after_the_chunks(entry, dtype):
    """Both forward entries take fwd_plan_args's five numbers right after the
    chunk counts, as the wrappers pass them, and tc_plan holds the plan's
    shared memory to its own count."""
    text = (kernels.CSRC_DIR / f"{entry}.cu").read_text()
    assert _params(text, f"{entry}_{dtype}")[-8:] == [
        "nk", "nv", "pack", "groups", "wg", "tk", "smem", "stream"]
    assert "smem == static_cast<size_t>(wp.smem)" in WIDE
    assert "tc_plan(pl, TcKernel::fwd, g, Y, Z, NTO, 4, wp)" in WIDE


def _body(name: str) -> str:
    """The text of the kernel ``name`` of attention_wide.cuh, up to the next
    top-level closing brace."""
    start = re.search(rf"^{name}\(", WIDE, re.M).start()
    return WIDE[start:WIDE.index("\n}\n", start)]


def _function(head: str) -> str:
    """The text of the function of attention_wide.cuh whose declaration
    starts with ``head``, up to its closing brace."""
    start = WIDE.index(head)
    return WIDE[start:WIDE.index("\n}\n", start)]


def test_forward_and_pass_dq_share_the_rc_rows():
    """The tensor-core forward and pass dq reach the RC rows through the one
    rc_rows, from the same staged query rows, so the backward's p = exp(S -
    lse) sees the forward's S; neither has a copy of the sums. rc_rows reads
    the qr lanes by rc_at and sums the heads-in-lanes lanes as rc_at does:
    f32 fmaf of q[d] and R[d] into the lane's sum, d in order from 0."""
    for kernel in ("fwd_tc_kernel", "dq_tc_kernel"):
        body = _body(kernel)
        assert body.count("rc_rows(rel_s, rs, rel, q, qo_s, ks, kb_s, tiles_bytes, vt, q0, g, tid);"
                          ) == 1, kernel
        assert "rc_at(" not in body and "rc_sums" not in body and "fmaf" not in body, kernel
    rows = _function("__device__ __forceinline__ void rc_rows(float* rel_s, int rs,")
    assert "rc_at(rel, q," in rows and "rc_sums<4>" in rows and "rc_sums<1>" in rows
    sums = _function("__device__ __forceinline__ void rc_sums(")
    assert "for (int ci = 0; ci < nchunks; ++ci)" in sums  # chunks of d in order
    assert "rc_task_sums(tk, q_s, scratch + (ci & 1) * chunk + roff, c0, c0, c0 + dn, q4)" in sums
    assert "rc_task_sums(tk, q_s, Rax" in sums and "tk.x[i][jj] = 0.f;" in sums
    task = _function("__device__ __forceinline__ void rc_task_sums(")
    assert "for (int u = 0; u < 4; ++u)" in task and "for (; d < d1; ++d)" in task
    assert "tk.x[i][j] = fmaf(qv[i][u], rv[j], tk.x[i][j]);" in task
    assert "tk.x[i][j] = fmaf(qv, rp[j], tk.x[i][j]);" in task
    at = _function("__device__ __forceinline__ float rc_at(")
    assert "float s = 0.f;" in at and "for (int d = 0; d < g.dkh; ++d)" in at
    assert "s = fmaf(to_f(qt[d]), __ldg(base + static_cast<size_t>(d) * stride), s);" in at


def test_forward_is_one_block_per_query_tile():
    """The forward no longer splits out over value chunks on the grid: no
    chunk index of the block, lse written once per row by group 0, copies
    by cp.async through stage_v with no per-element division."""
    body = _body("fwd_tc_kernel")
    assert "% g.nv" not in body and "chunk" not in body
    assert "stage<" not in body and body.count("stage_v(") == 3  # q; k, v a tile
    assert "tc.group == 0 && t == 0" in body
    assert "fwd_mma_kernel" not in WIDE


def test_the_no_atomics_scan_covers_the_forward():
    """tests/test_torch_kernel_sources.py's scan of every csrc file named
    *attention* covers the header that holds the rewritten forward."""
    assert "fwd_tc_kernel" in WIDE
    assert not re.search(r"\batomic\w*\s*\(|\bred\.global|\batom\.", WIDE)


LOG2E = 1.4426950408889634


def _rehearsal(qr, k, v, H, W, dkh, pack, tk):
    """The kernel's arithmetic on the CPU in f32: the (batch, head) pairs of
    qr / k / v (bn, hw, ...) taken ``pack`` a 64-token tile (the last tile
    partial where bn is not a multiple), virtual token v of a tile being
    token v % hw of pair v // hw; per key tile of ``tk`` virtual keys, S =
    q k^T + the RC lanes at the key's column and row, masked past the tile's
    last key and to the query's own pair, then the online softmax as
    fwd_tc_kernel takes it (max over the tile, the shift 0 while a row has
    seen no key of its pair, p = 2^(S log2e - m log2e)). Returns (out, lse)
    per pair."""
    bn, hw, _ = qr.shape
    col, row = fa.key_positions(hw, W, qr.device)
    out = torch.empty(bn, hw, v.shape[-1])
    lse = torch.empty(bn, hw)
    for p0 in range(0, bn, pack):
        pairs = list(range(p0, min(p0 + pack, bn)))
        n = len(pairs) * hw
        q_t = torch.cat([qr[p, :, :dkh] for p in pairs])           # (n, dkh)
        rc_t = torch.cat([qr[p, :, dkh:] for p in pairs])          # (n, W + H)
        k_t = torch.cat([k[p] for p in pairs])
        v_t = torch.cat([v[p] for p in pairs])
        own = torch.arange(n) // hw                                # each token's pair in the tile
        m = torch.full((n,), -math.inf)
        ln = torch.zeros(n)
        acc = torch.zeros(n, v.shape[-1])
        for j0 in range(0, n, tk):
            j = torch.arange(j0, min(j0 + tk, n))
            s = q_t @ k_t[j].T + rc_t[:, col[j % hw]] + rc_t[:, W + row[j % hw]]
            s = torch.where(own[:, None] == own[j][None, :], s, torch.tensor(-math.inf))
            mn = torch.maximum(m, s.max(1).values)
            ml = torch.where(mn == -math.inf, torch.zeros(()), mn * LOG2E)
            alpha = torch.where(mn == m, torch.ones(()), torch.exp2(m * LOG2E - ml))
            pm = torch.exp2(s * LOG2E - ml[:, None])
            ln = ln * alpha + pm.sum(1)
            acc = acc * alpha[:, None] + pm @ v_t[j]
            m = mn
        for i, p in enumerate(pairs):
            out[p] = acc[i * hw:(i + 1) * hw] / ln[i * hw:(i + 1) * hw, None]
            lse[p] = (m + torch.log(ln))[i * hw:(i + 1) * hw]
    return out, lse


@pytest.mark.parametrize("H,W,bn,pack,tk", [(1, 1, 7, 3, 32), (2, 2, 11, 4, 32), (5, 5, 5, 2, 16),
                                            (4, 4, 9, 4, 16), (3, 3, 1, 1, 32), (1, 1, 10, 4, 32)])
def test_packed_tile_rehearsal_matches_the_plain_forward(H, W, bn, pack, tk):
    """The rehearsal of packed tiles gives the plain forward's out and lse
    per pair within 1e-6 in f32: the block-diagonal mask keeps each pair to
    its own keys, a partial last pack is whole (bn not a multiple of the
    pack), and a row whose first key tile holds none of its keys (5x5 at 16
    keys a tile) does not poison its softmax."""
    dkh, dvh = 160, 24
    assert pack * H * W <= fa.BW_ROWS
    g = torch.Generator().manual_seed(H * 100 + bn)
    hw = H * W
    qr = torch.randn(bn, hw, dkh + W + H, generator=g)
    qr[..., :dkh] *= dkh ** -0.5
    k = torch.randn(bn, hw, dkh, generator=g)
    v = torch.randn(bn, hw, dvh, generator=g)
    got = _rehearsal(qr, k, v, H, W, dkh, pack, tk)
    want = fa.rel_attention_fwd_plain(qr, k, v, H, W, dkh)
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)


RC_QS = 4


def _rc_tasks(H, W, hw_tile, q0, pack):
    """rc_sums's tasks (csrc/attention_wide.cuh) in Python: for every task,
    its axis, R row, first lane and the tile rows of its queries."""
    G = 4 if W % 4 == 0 and H % 4 == 0 else 1
    nq = hw_tile
    packed = pack > 1
    hw = H * W
    np_ = nq // hw if packed else 1
    rho0_h = 0 if packed else q0 // W
    nrho_h = H if packed else (q0 + nq - 1) // W - q0 // W + 1
    nset_w = -(-(np_ * H) // RC_QS) if packed else -(-(-(-nq // W)) // RC_QS)
    nset_h = -(-(np_ * W) // RC_QS) if packed else -(-min(W, nq) // RC_QS)
    tasks_w = W * (W // G) * nset_w
    tasks = tasks_w + nrho_h * (H // G) * nset_h
    out = []
    for f in range(tasks):
        ax = 1 if f >= tasks_w else 0
        ff = f - tasks_w if ax else f
        lgs, nset = (H if ax else W) // G, nset_h if ax else nset_w
        st, lg, rho = ff % nset, ff // nset % lgs, ff // nset // lgs + (rho0_h if ax else 0)
        qs = []
        for i in range(RC_QS):
            j = st * RC_QS + i
            v = -1
            if packed:
                per = W if ax else H
                pp, k = divmod(j, per)
                if pp < np_:
                    v = pp * hw + (rho * W + k if ax else k * W + rho)
            elif ax == 0:
                first = q0 + ((rho - q0 % W) % W + W) % W
                if first + j * W < q0 + nq:
                    v = first + j * W - q0
            else:
                lo, hi = max(q0, rho * W), min(q0 + nq, rho * W + W)
                if lo + j < hi:
                    v = lo + j - q0
            qs.append(v)
        out.append((ax, rho, lg * G, G, qs))
    return out


@pytest.mark.parametrize("H,W,q0,nq,pack", [
    (16, 16, 0, 64, 1), (16, 16, 192, 64, 1), (8, 8, 0, 64, 1), (10, 10, 64, 36, 1),
    (20, 20, 320, 64, 1), (5, 7, 0, 35, 1), (64, 64, 4032, 64, 1), (1, 1, 0, 4, 4),
    (1, 1, 0, 3, 4), (2, 2, 0, 12, 4), (4, 4, 0, 32, 2), (5, 5, 0, 50, 2), (9, 9, 64, 17, 1)])
def test_rc_tasks_cover_every_lane_once(H, W, q0, nq, pack):
    """rc_sums's tasks, as the kernel numbers them: every (query, lane) of
    the tile's queries is summed by exactly one task, from the R row of its
    image column (W lanes) or row (H lanes), and a task's queries share that
    row; at 16x16 a tile is 128 tasks, one a thread of a warp group."""
    hw = H * W
    seen = {}
    tasks = _rc_tasks(H, W, nq, q0, pack)
    for ax, rho, c, G, qs in tasks:
        for v in qs:
            if v < 0:
                continue
            tok = v % hw if pack > 1 else q0 + v
            assert (tok // W if ax else tok % W) == rho
            for j in range(G):
                lane = (W if ax else 0) + c + j
                seen[(v, lane)] = seen.get((v, lane), 0) + 1
    assert seen == {(v, lane): 1 for v in range(nq) for lane in range(W + H)}
    if (H, W) == (16, 16):
        assert len(tasks) == 128


@pytest.mark.parametrize("H,W,dkh,dvh,instance", [(16, 16, 160, 64, 8), (8, 8, 150, 75, 12),
                                                  (8, 8, 320, 128, 16), (1, 1, 512, 256, 32),
                                                  (8, 8, 640, 320, 32)])
def test_smoke_reports_the_forward_instance_registers(monkeypatch, H, W, dkh, dvh, instance):
    """chip_smoke.py's phase 19 width rows carry the registers and spill of
    the wide forward's instance that ran (fwd_instance of the plan), read by
    its kernel name from the report kernels.build keeps."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    plan = fa.wide_fwd_plan(H, W, dkh, dvh, 512)
    assert fa.fwd_instance(plan) == instance
    report = [{"kernel": f"void attention_wide::fwd_tc_kernel<{n}>(attention_wide::TcPlan)",
               "registers": 100 + n, "spill_stores": 0} for n, _ in fa.FWD_INSTANCES]
    monkeypatch.setattr(kernels, "ptxas_report", lambda target: report)
    got = chip_smoke.forward_registers("rel_attention_fwd", plan)
    assert got == {"kernel": f"fwd_tc_kernel<{instance}>", "registers": 100 + instance,
                   "spill_stores": 0}
