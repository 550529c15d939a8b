"""The host-side plan of the attention backward's kernels, on the CPU: the
plans that ``ops/fused_attention.py`` chooses for ``csrc/attention_wide.cuh``
(the tensor-core passes of heads past the largest width class) and
``ops/hil_attention.py`` for ``csrc/hil_attention_bwd.cu``'s pass drel, which
the wrappers pass to the entries and the kernels check, held against the
sources' constants and entries and at every head and map the CIFAR bench's
flags and the model zoo reach; the register report that ``chip_smoke.py``
reads from each build. No compiler and no card: the kernels themselves run,
and refuse plans they cannot run, in tests/test_torch_kernels_cuda.py."""

import re
import sys
from pathlib import Path

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops import fused_attention as fa
from chexpert_tpu_torch.ops import hil_attention as hil

WIDE = (kernels.CSRC_DIR / "attention_wide.cuh").read_text()
HIL_BWD = (kernels.CSRC_DIR / "hil_attention_bwd.cu").read_text()

# heads past (128, 64) at their maps: chip_smoke.py's WIDE_GEOS (the bench's
# --attn_k 0.5 --attn_v 0.2 --attn_nh 1 heads, densenet 12 100's (150, 75),
# resnet 50's (512, 256) at 1x1), --attn_k 1.0 --attn_v 0.5 --attn_nh 1 of
# WideResNet-28-10 (up to (640, 320)), resnet 50's heads on its 2x2 and 4x4
# maps, and the card tests' wide cases
WIDE_HEADS = [(16, 16, 160, 64), (8, 8, 320, 128), (8, 8, 150, 75), (1, 1, 512, 256),
              (16, 16, 320, 160), (8, 8, 640, 320), (2, 2, 512, 256), (4, 4, 256, 128),
              (5, 7, 129, 8), (9, 9, 20, 65), (64, 64, 256, 128), (10, 10, 160, 64),
              (20, 20, 150, 75)]


def _constant(text: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1).replace("BW_WARPS", "4")))  # noqa: S307 - a literal product


@pytest.mark.parametrize("name,value", [("BW_ROWS", fa.BW_ROWS), ("NTO", fa.BW_NTO),
                                        ("NTO_BINS", fa.BW_NTO_BINS),
                                        ("BW_SMEM_MAX", fa.BW_SMEM_MAX), ("BW_WG", fa.BW_WG)])
def test_plan_constants_match_the_source(name, value):
    """The Python plan uses the tile rows, the n8 tiles a warp holds, the
    shared memory of a block and the warp groups a block that
    csrc/attention_wide.cuh checks a plan against."""
    assert _constant(WIDE, name) == value


@pytest.mark.parametrize("name,value", [("DREL_SMEM_MAX", hil.DREL_SMEM_MAX),
                                        ("DREL_LANES", hil.DREL_LANES)])
def test_drel_constants_match_the_source(name, value):
    assert _constant(HIL_BWD, name) == value


@pytest.mark.parametrize("H,W,pack", [(1, 1, 64), (2, 2, 16), (4, 4, 4), (5, 5, 2), (4, 8, 2),
                                      (5, 7, 1), (8, 8, 1), (16, 16, 1)])
def test_tiny_maps_pack_several_heads_a_tile(H, W, pack):
    """A wide head on a map of at most 32 tokens packs 64 // hw (batch, head)
    pairs into one 64-token tile; larger maps, and every head a width class
    holds, pack one."""
    assert fa.bwd_pack(H, W, 512, 256) == pack
    assert fa.bwd_pack(H, W, 128, 64) == 1
    assert fa.wide_bwd_plan(H, W, 512, 256)["pack"] == pack
    for name in ("dq", "dkdv"):  # what the entries take, and the key table's copies
        assert fa.bwd_plan_args(name, torch.bfloat16, H, W, 512, 256)[0] == pack


@pytest.mark.parametrize("H,W,pack", [(1, 1, 64), (2, 2, 16), (4, 4, 4), (5, 5, 2)])
def test_packed_key_table_repeats_the_map(H, W, pack):
    """The key table of a packed tile: one row of 64 keys, key v the map's
    token v % hw for v < pack * hw (its kpos), no key after; the one-hot
    fragments hold one hit per such key and bin axis."""
    hw = H * W
    tab = fa.key_table(H, W, torch.device("cpu"), pack)
    assert tab.shape[0] == 1
    kpos = tab[0, -fa.KEY_TILE:]
    want = [(v % hw % W) | (v % hw // W) << 16 if v < pack * hw else 0
            for v in range(fa.KEY_TILE)]
    assert kpos.tolist() == want
    nbt = fa.bin_tiles(H, W)
    frags = tab[0, :4 * nbt * 64].view(4, nbt, 32, 2)
    hits = sum(bin(int(w) & 0xffffffff).count("1") for w in frags.flatten()) // 7
    assert hits == 2 * pack * hw  # bf16 1.0 has 7 set bits; a key hits a column and a row bin
    assert torch.equal(fa.key_table(H, W, torch.device("cpu"), 1),
                       fa.key_table(H, W, torch.device("cpu")))


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("H,W,dkh,dvh", WIDE_HEADS)
def test_wide_heads_fit_one_block(H, W, dkh, dvh, layout):
    """Every wide head the bench's flags reach runs both tensor-core passes
    where its map is on the tensor cores: shared memory within 232,448
    bytes a block, the column groups cover every n8 output tile of the pass
    in groups of at most NTO (NTO_BINS for dq past 4 bin tiles), at most
    BW_WG groups a block."""
    plan = fa.wide_bwd_plan(H, W, dkh, dvh, layout)
    if not fa.on_tensor_cores(torch.bfloat16, H, W):
        assert plan["dq"] is None and plan["dkdv"] is None
        return
    for name in ("dq", "dkdv"):
        p = plan[name]
        assert p is not None and p["smem"] <= fa.BW_SMEM_MAX
        tiles = -(-dkh // 8) + (0 if name == "dq" else -(-dvh // 8))
        cap = fa.BW_NTO if name == "dkdv" or fa.bin_tiles(H, W) <= 4 else fa.BW_NTO_BINS
        assert p["tiles"] <= cap and p["groups"] * p["tiles"] >= tiles
        assert (p["groups"] - 1) * p["tiles"] < tiles
        assert p["warp_groups"] == (fa.BW_WG if p["groups"] > 1 else 1)
        assert p["blocks_per_tile"] * p["warp_groups"] >= p["groups"]
        assert p["tk"] in (16, 32)


@pytest.mark.parametrize("H,W,dkh,dvh,dq_groups,dkdv_groups", [
    (16, 16, 160, 64, 1, 1), (8, 8, 320, 128, 2, 2), (8, 8, 150, 75, 1, 1),
    (1, 1, 512, 256, 2, 3), (8, 8, 640, 320, 3, 4)])
def test_column_groups_of_the_bench_heads(H, W, dkh, dvh, dq_groups, dkdv_groups):
    """S and p are formed once per tile pair for every output column of a
    block: one group at (160, 64) and (150, 75); the widest heads take
    groups, two a block, which recompute S for their columns."""
    plan = fa.wide_bwd_plan(H, W, dkh, dvh)
    assert (plan["dq"]["groups"], plan["dkdv"]["groups"]) == (dq_groups, dkdv_groups)


def test_rows_too_wide_for_a_block_take_the_cuda_cores():
    """A head whose rows do not fit shared memory even at 16 other tokens a
    tile has no tensor-core plan (the CUDA-core passes take it)."""
    assert fa.wide_bwd_plan(8, 8, 1200, 600)["dq"] is None
    assert fa.bwd_plan_args("dq", torch.bfloat16, 8, 8, 1200, 600) == (0,) * 5


@pytest.mark.parametrize("layout", ["bn", "hil"])
@pytest.mark.parametrize("name", ["dq", "dkdv"])
@pytest.mark.parametrize("H,W,dkh,dvh", WIDE_HEADS)
def test_entries_take_the_plan(H, W, dkh, dvh, name, layout):
    """bwd_plan_args is wide_bwd_plan's plan as the wrappers pass it: (pack,
    groups, warp groups, tk, shared memory) for a bf16 head on the tensor
    cores, all 0 (the CUDA-core passes) for f32 and maps past them."""
    plan = fa.wide_bwd_plan(H, W, dkh, dvh, layout)
    got = fa.bwd_plan_args(name, torch.bfloat16, H, W, dkh, dvh, layout)
    p = plan[name]
    if p is None:
        assert got == (0,) * 5
    else:
        assert got == (plan["pack"], p["groups"], p["warp_groups"], p["tk"], p["smem"])
    assert fa.bwd_plan_args(name, torch.float32, H, W, dkh, dvh, layout) == (0,) * 5


@pytest.mark.parametrize("dkh,dvh", [(20, 4), (64, 32), (128, 64)])
def test_heads_a_class_holds_pass_no_plan(dkh, dvh):
    """The classes' kernels take no wide plan: the wrappers pass zeros."""
    for name in ("dq", "dkdv"):
        assert fa.bwd_plan_args(name, torch.bfloat16, 8, 8, dkh, dvh) == (0,) * 5


def _params(text: str, entry: str) -> list:
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("entry,source", [
    (fa.BWD_DKDV, "rel_attention_bwd"), (fa.BWD_DQ, "rel_attention_bwd"),
    (hil.BWD_DKDV, "hil_attention_bwd"), (hil.BWD_DQ, "hil_attention_bwd")])
def test_backward_entries_take_the_plan_after_the_chunks(entry, source, dtype):
    """Every dq / dkdv entry takes bwd_plan_args's five numbers right after
    the chunk counts, as the wrappers pass them, and attention_wide.cuh's
    tc_plan holds the plan's shared memory to its own count."""
    text = (kernels.CSRC_DIR / f"{source}.cu").read_text()
    assert _params(text, f"{entry}_{dtype}")[-8:] == [
        "nk", "nv", "pack", "groups", "wg", "tk", "smem", "stream"]
    assert "smem == static_cast<size_t>(wp.smem)" in WIDE


def test_ptxas_report_outlives_the_build(tmp_path, monkeypatch):
    """kernels.build keeps nvcc's -Xptxas -v report beside the library, so
    ptxas_report reads it on a later run that finds the library current
    (a fake nvcc writes the library and a report here)."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n"
                    "while [ \"$1\" != -o ]; do shift; done; echo lib > \"$2\"\n"
                    "echo \"ptxas info    : Compiling entry function '_Z8dq_tc_kernelv' "
                    "for 'sm_90a'\"\n"
                    "echo \"ptxas info    : Function properties for _Z8dq_tc_kernelv\"\n"
                    "echo \"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                    "loads\"\n"
                    "echo \"ptxas info    : Used 241 registers, 16 bytes smem\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    target = ("hil_attention_bwd", ("-DATTN_KW=128", "-DATTN_VW=64"))
    assert kernels.ptxas_report(target) == []
    assert kernels.build([target])[kernels.label(target)] > 0
    assert kernels.build([target])[kernels.label(target)] == 0.0  # current: no nvcc
    (r,) = kernels.ptxas_report(target)
    assert (r["registers"], r["spill_stores"], r["static_smem"]) == (241, 0, 16)


def test_smoke_reports_registers_by_pass(monkeypatch):
    """chip_smoke.py's phase 19 rows read each pass's registers from the
    library's report by the pass its kernels' names carry, whatever their
    namespace and template arguments."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    names = ["void attention_wide::dq_tc_kernel<16, 16>(attention_wide::Geo)",
             "void (anonymous namespace)::mma_passes::hil_attention_bwd_dq_mma_kernel<4, 16, 0>"
             "(int)",
             "void attention_wide::dkdv_tc_kernel<float>(attention_wide::TcPlan)",
             "void (anonymous namespace)::hil_attention_bwd_drel_kernel<float, 32>(float*)"]
    report = [{"kernel": n, "registers": r, "spill_stores": s}
              for n, r, s in zip(names, (241, 156, 253, 56), (0, 0, 8, 0))]
    monkeypatch.setattr(kernels, "ptxas_report", lambda target: report)
    got = chip_smoke.pass_registers("hil_attention_bwd", (128, 64))
    assert got["dq"] == {"registers": 241, "spill_stores": 0, "kernels": 2}
    assert got["dkdv"] == {"registers": 253, "spill_stores": 8, "kernels": 1}
    assert got["drel"]["kernels"] == 1 and got["fwd"]["registers"] is None


# pass drel at the bench's geometries (batch 256: WideResNet-28-10 --attn
# with 8, 2 and 1 heads and its wide heads at 16x16 and 8x8, densenet 12 100's
# (150, 75), resnet 50's maps down to 1x1) and the zoo's (batch 16, 8 heads,
# dkh 20: aaresnet152 and aadensenet121 at 40x40, 20x20, 10x10)
DREL_GEOS = ([(256, n, n, nh, dkh, dvh) for n in (16, 8)
              for nh, dkh, dvh in ((8, 20, 4), (2, 32, 16), (2, 64, 32), (1, 160, 64),
                                   (1, 320, 128), (1, 128, 64), (4, 24, 8))]
             + [(256, 8, 8, 1, 150, 75)]
             + [(256, n, n, 1, 512, 256) for n in (4, 2, 1)]
             + [(16, n, n, 8, 20, dvh) for n, dvh in ((40, 1), (20, 3), (10, 6))])


@pytest.mark.parametrize("B,H,W,nh,dkh,dvh", DREL_GEOS)
def test_drel_blocks_hold_128_threads(B, H, W, nh, dkh, dvh):
    """drel_plan gives every block at least 128 threads (16 at 8x8 with two
    heads before batch elements shared one), at most 1024, and partial sums
    within the shared memory a block may hold; 40x40 with 8 heads keeps one
    batch element a block."""
    hsplit, bsplit = hil.drel_plan(B, H, W, nh, dkh)
    threads = max(H, W) * hsplit * bsplit
    dc = min(dkh, hil.DREL_LANES)
    assert 128 <= threads <= 1024
    assert 1 <= hsplit <= nh and 1 <= bsplit <= B
    assert bsplit * hsplit * dc * max(H, W) * 4 <= hil.DREL_SMEM_MAX
    if (H, nh) == (40, 8):
        assert (hsplit, bsplit) == (8, 1)


def test_the_no_atomics_scan_covers_every_attention_source():
    """tests/test_torch_kernel_sources.py scans each csrc file named
    *attention*: every local header an attention source includes is one of
    them, so the redesigned passes (attention_wide.cuh) are scanned."""
    scanned = {p.name for p in kernels.CSRC_DIR.glob("*attention*")}
    assert {"attention_wide.cuh", "attention_bwd_mma.cuh", "rel_attention_bwd.cu",
            "hil_attention_bwd.cu"} <= scanned
    for name in [n for n in scanned if n.endswith(".cu")]:
        for inc in re.findall(r'#include "([^"]+)"', (kernels.CSRC_DIR / name).read_text()):
            assert inc in scanned, (name, inc)
