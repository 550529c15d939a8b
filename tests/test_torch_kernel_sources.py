"""Source-level checks of the port's CUDA kernels that need no compiler.

A host without nvcc cannot build ``chexpert_tpu_torch/csrc``; these tests
read the sources instead: every C entry a wrapper looks up
(``{kernel name}_{f32,bf16}``) is defined as ``extern "C"`` in the ``.cu``
file the wrapper loads, every ``#include "x.cuh"`` names a file that exists,
constants that a wrapper repeats agree with the source (the head-width
classes among them), the attention entries take their pointers in the order
the wrappers pass them, and no pass adds through an atomic. ``width_class``
and ``width_plan`` are held to the head widths the bench's flags reach."""

import re

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops import depthwise, fused_attention, hil_attention, kernel_targets

# (kernel name, the source its wrapper loads)
ENTRIES = [
    (fused_attention.NAME, fused_attention.NAME),
    (fused_attention.BWD_DKDV, fused_attention.BWD_SOURCE),
    (fused_attention.BWD_DQ, fused_attention.BWD_SOURCE),
    (hil_attention.FWD, hil_attention.FWD),
    (hil_attention.BWD_DKDV, hil_attention.BWD_SOURCE),
    (hil_attention.BWD_DQ, hil_attention.BWD_SOURCE),
    (hil_attention.BWD_DREL, hil_attention.BWD_SOURCE),
    (depthwise.FWD, depthwise.FWD),
    (depthwise.BWD, depthwise.BWD),
]
_MACRO = re.compile(r"^#define\s+(\w+)\((\w+)(?:,\s*\w+)*\)\s*\\\n\s*extern \"C\" int \2\(", re.M)


def _extern_c_names(text: str) -> set:
    """Names defined as ``extern "C" int name(`` directly, or through a
    ``#define X_ENTRY(NAME, ...) extern "C" int NAME(`` macro and its uses."""
    names = set(re.findall(r'^extern "C" int (\w+)\(', text, re.M))
    for macro, _ in _MACRO.findall(text):
        names.update(re.findall(rf"^{macro}\((\w+)", text, re.M))
    return names


@pytest.mark.parametrize("suffix", ["f32", "bf16"])
@pytest.mark.parametrize("name,source", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_every_entry_a_wrapper_looks_up_is_defined(name, source, suffix):
    path = kernels.CSRC_DIR / f"{source}.cu"
    assert path.exists(), path
    assert f"{name}_{suffix}" in _extern_c_names(path.read_text())


def test_entry_list_covers_the_wrappers_and_the_sources():
    assert sorted({source for _, source in ENTRIES}) == kernels.sources()
    assert len({name for name, _ in ENTRIES}) == 9


@pytest.mark.parametrize("path", sorted(kernels.CSRC_DIR.glob("*.cu*")), ids=lambda p: p.name)
def test_every_included_header_exists(path):
    for header in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M):
        assert (kernels.CSRC_DIR / header).exists(), f"{path.name} includes {header}"


def test_constants_repeated_in_python_agree_with_the_source():
    core = (kernels.CSRC_DIR / "attention_bwd_mma.cuh").read_text()
    tiles = int(re.search(r"constexpr int MAX_BIN_TILES = (\d+);", core).group(1))
    assert tiles == fused_attention.MMA_MAX_BIN_TILES
    assert int(re.search(r"constexpr int TN = (\d+);", core).group(1)) == fused_attention.KEY_TILE
    # the width classes: the sources take their widths from the build, each
    # class's (KW, VW) is one the core admits, and both wrappers use one rule
    assert "constexpr int KW = ATTN_KW;" in core and "constexpr int VW = ATTN_VW;" in core
    kws = {int(x) for x in re.findall(r"KW == (\d+)", re.search(
        r"static_assert\((KW == \d+(?: \|\| )?)+", core).group(0))}
    vws = {int(x) for x in re.findall(r"VW == (\d+)", re.search(
        r"static_assert\((VW == \d+(?: \|\| )?)+", core).group(0))}
    assert {kw for kw, _ in fused_attention.WIDTH_CLASSES} <= kws
    assert {vw for _, vw in fused_attention.WIDTH_CLASSES} <= vws
    assert hil_attention.width_library is fused_attention.width_library
    assert not hasattr(hil_attention, "SUPPORTED_DKH") and not hasattr(fused_attention, "MAX_DVH")
    assert fused_attention.on_tensor_cores(torch.bfloat16, 64, 64)
    assert not fused_attention.on_tensor_cores(torch.bfloat16, 72, 64)
    assert not fused_attention.on_tensor_cores(torch.float32, 8, 8)


def _params(text: str, entry: str) -> list:
    """Parameter names of ``extern "C" int entry(...)``."""
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


@pytest.mark.parametrize("suffix", ["f32", "bf16"])
@pytest.mark.parametrize("name,params", [
    (fused_attention.NAME,
     "qr k v tab out lse bn hw H W dkh dvh nk nv pack groups wg tk smem stream"),
    (hil_attention.FWD,
     "P Rw Rh tab out lse B hw H W nh slot dkh dvh nk nv pack groups wg tk smem stream"),
])
def test_forward_entries_take_the_key_table(name, params, suffix):
    """Both forwards take the key table's pointer after their operands, as
    ``rel_attention_fwd`` / ``hil_attention_fwd`` pass it (None off the
    tensor-core route), the head's chunk counts of ``width_plan`` after
    its widths and the wide forward's plan (``fwd_plan_args``) after them."""
    text = (kernels.CSRC_DIR / f"{name}.cu").read_text()
    assert _params(text, f"{name}_{suffix}") == params.split()


@pytest.mark.parametrize("source,routed", [("rel_attention_fwd", 1), ("hil_attention_fwd", 1),
                                           ("rel_attention_bwd", 2), ("hil_attention_bwd", 2)])
def test_every_attention_source_routes_bf16_by_one_rule(source, routed):
    """The tensor-core rule is stated once in the sources (amma::mma_fits over
    the bin tiles) and once in Python (on_tensor_cores); every attention
    source routes each of its bf16 kernels (the forward; dkdv and dq) by it,
    and no f32 entry consults it."""
    core = (kernels.CSRC_DIR / "attention_bwd_mma.cuh").read_text()
    assert re.search(r"inline bool mma_fits\(int W, int H\) \{ return bin_tiles\(W, H\) <= "
                     r"MAX_BIN_TILES; \}", core)
    text = (kernels.CSRC_DIR / f"{source}.cu").read_text()
    assert text.count("if (!amma::mma_fits(W, H))") == routed
    f32 = [e.split("\n}")[0] for e in re.split(r'^extern "C" int ', text, flags=re.M)[1:]
           if re.match(r"\w+_f32\(", e)]
    assert f32 and not any("mma" in body for body in f32)


def test_forward_tiles_agree_with_the_key_table():
    """The forwards read the key positions as the last TN = KEY_TILE words of
    each key-table row, which is where ``key_table`` puts them."""
    fwd = (kernels.CSRC_DIR / "attention_fwd_mma.cuh").read_text()
    assert "tab + static_cast<size_t>(tile) * words + (words - TN)" in fwd
    tab = fused_attention.key_table(5, 7, torch.device("cpu"))
    j = torch.arange(35)
    assert torch.equal(tab[0, -fused_attention.KEY_TILE:][:35].long(), (j % 7) | ((j // 7) << 16))
    assert fused_attention.on_tensor_cores(torch.bfloat16, 120, 8)
    assert not fused_attention.on_tensor_cores(torch.bfloat16, 127, 2)


def _includes(name: str) -> set:
    """The headers a source includes, directly or through other headers."""
    seen, todo = set(), [name]
    while todo:
        text = (kernels.CSRC_DIR / todo.pop()).read_text()
        for header in re.findall(r'^#include "([^"]+)"', text, re.M):
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return seen


def test_width_classes_are_built_into_every_attention_source():
    """The sources built once per width class are exactly those that include
    the core that reads ATTN_KW / ATTN_VW; the build's targets name every
    (source, class) once, with the defines the core reads, and the ops'
    targets build every source; the classes grow in both widths."""
    core = "attention_bwd_mma.cuh"
    assert set(fused_attention.WIDTH_SOURCES) == {
        s for s in kernels.sources() if core in _includes(f"{s}.cu")}
    classes = fused_attention.WIDTH_CLASSES
    assert list(classes) == sorted(classes) and classes[0] == (32, 8)
    assert all(b[0] >= a[0] and b[1] >= a[1] for a, b in zip(classes, classes[1:]))
    targets = fused_attention.width_targets()
    assert len(targets) == len(set(targets)) == len(classes) * len(fused_attention.WIDTH_SOURCES)
    for kw, vw in classes:
        defines = fused_attention.width_defines((kw, vw))
        assert defines == (f"-DATTN_KW={kw}", f"-DATTN_VW={vw}")
        for source in fused_attention.WIDTH_SOURCES:
            assert (source, defines) in targets
    paths = {kernels._lib_path(t) for t in targets}
    assert len(paths) == len(targets)  # each class its own library
    # the ops' libraries build every source, the depthwise ones without defines
    built = kernel_targets()
    assert {name for name, _ in built} == set(kernels.sources())
    assert set(targets) <= set(built) and len(built) == len(set(built))


# (bench flags past --attn, dkh, dvh) of WideResNet-28-10's AA convs: the
# heads that the JAX package's models/attn.py sizes as max(20, k C / nh) and
# v C / nh, which the card once refused (ROADMAP C.17)
BENCH_HEADS = [
    ((), (20, 4)), ((), (20, 8)),
    (("--attn_nh", "4"), (32, 16)),
    (("--attn_nh", "2"), (64, 32)), (("--attn_nh", "2"), (32, 16)),
    (("--attn_nh", "1"), (128, 64)), (("--attn_nh", "1"), (64, 32)),
    (("--attn_k", "0.3"), (24, 8)), (("--attn_k", "0.33"), (26, 8)),
    (("--attn_v", "0.2"), (20, 16)),
]


@pytest.mark.parametrize("flags,head", BENCH_HEADS, ids=lambda x: str(x))
def test_width_class_holds_every_head_the_bench_flags_reach(flags, head):
    """WideResNet-28-10 --attn with the flags has an AA conv of head widths
    ``head``, and the smallest class holding it is width_class's answer."""
    from chexpert_tpu_torch.cli import bench
    from chexpert_tpu_torch.models import AAConv2d, AttnParams, WideResNet

    args = bench.build_parser().parse_args(["wideresnet", "28", "10", "--attn", *flags])
    attn = AttnParams(args.attn_k, args.attn_v, args.attn_nh, args.attn_relative,
                      tuple(args.input_dims))
    with torch.device("meta"):
        model = WideResNet(28, 10, attn=attn)
    heads = {(m.dk // m.nh, m.dv // m.nh) for m in model.modules() if isinstance(m, AAConv2d)}
    assert head in heads
    kw, vw = fused_attention.width_class(*head)
    assert head[0] <= kw and head[1] <= vw
    smaller = [c for c in fused_attention.WIDTH_CLASSES if c[0] * c[1] < kw * vw]
    assert not any(head[0] <= c[0] and head[1] <= c[1] for c in smaller)


@pytest.mark.parametrize("dkh,dvh,nk,nv", [(129, 8, 2, 1), (20, 65, 1, 2), (320, 160, 3, 3)])
def test_width_plan_holds_heads_past_the_largest_class(dkh, dvh, nk, nv):
    """``--attn_k 0.5 --attn_nh 1`` gives dkh 320: the largest class's library
    takes it, in ceil(dkh / 128) key chunks and ceil(dvh / 64) value chunks."""
    assert fused_attention.width_class(dkh, dvh) == fused_attention.WIDTH_CLASSES[-1] == (128, 64)
    assert fused_attention.width_plan(dkh, dvh) == ((128, 64), nk, nv)


@pytest.mark.parametrize("dkh,dvh", [(0, 8), (20, 0)])
def test_width_class_refuses_widths_below_one(dkh, dvh):
    """No head has a width below 1: the error names both widths."""
    with pytest.raises(ValueError, match=rf"dkh={dkh}, dvh={dvh}"):
        fused_attention.width_class(dkh, dvh)
    with pytest.raises(ValueError, match=rf"dkh={dkh}, dvh={dvh}"):
        fused_attention.width_plan(dkh, dvh)


@pytest.mark.parametrize("source", sorted(
    p.name for p in kernels.CSRC_DIR.glob("*attention*")))
def test_attention_sources_use_no_atomics(source):
    """B2's and B6's passes each own what they write (deterministic): no
    attention source adds through an atomic, in any width class."""
    text = (kernels.CSRC_DIR / source).read_text()
    assert not re.search(r"\batomic\w*\s*\(|\bred\.global|\batom\.", text)


@pytest.mark.parametrize("source", ["depthwise_common.cuh", "depthwise_fwd.cu", "depthwise_bwd.cu"])
def test_depthwise_sources_use_no_atomics(source):
    """B4's dw partial rows have one writer per (row, channel, tap): no
    source of the depthwise kernels adds through an atomic."""
    text = (kernels.CSRC_DIR / source).read_text()
    assert not re.search(r"\batomic\w*\s*\(|\bred\.global|\batom\.", text)


def test_depthwise_partial_count_takes_k():
    """The wrapper passes k to depthwise_bwd_n_part, whose plan depends on it."""
    text = (kernels.CSRC_DIR / "depthwise_bwd.cu").read_text()
    assert re.search(r'extern "C" long long depthwise_bwd_n_part\(int B, int C, int H, int W, '
                     r'int k\)', text)
