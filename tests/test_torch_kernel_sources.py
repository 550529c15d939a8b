"""Source-level checks of the port's CUDA kernels that need no compiler.

A host without nvcc cannot build ``chexpert_tpu_torch/csrc``; these tests
read the sources instead: every C entry a wrapper looks up
(``{kernel name}_{f32,bf16}``) is defined as ``extern "C"`` in the ``.cu``
file the wrapper loads, every ``#include "x.cuh"`` names a file that exists,
and constants that a wrapper repeats agree with the source."""

import re

import pytest
import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.ops import depthwise, fused_attention, hil_attention

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
    dkh = int(re.search(r"constexpr int DKH = (\d+);", core).group(1))
    assert (dkh,) == hil_attention.SUPPORTED_DKH == fused_attention.SUPPORTED_DKH
    assert fused_attention.bwd_on_tensor_cores(torch.bfloat16, 64, 64)
    assert not fused_attention.bwd_on_tensor_cores(torch.bfloat16, 72, 64)
    assert not fused_attention.bwd_on_tensor_cores(torch.float32, 8, 8)
