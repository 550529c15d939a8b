"""Fused relative-position attention: wrappers of the hand-written CUDA
kernels ``csrc/rel_attention_fwd.cu`` (B1) and ``csrc/rel_attention_bwd.cu``
(B2), their plain PyTorch versions, and the autograd function that joins
them.

Ports of the TPU kernels chexpert_tpu/ops/pallas_attention.py::_fwd_kernel
(host side ``_flash_forward``) and ``_bwd_kernel`` (host side
``_flash_bwd_rule``). The wrappers take the packed query operand of
``ops.attention.pack_query`` flattened to (B*nh, HW, L):

  * a CUDA tensor launches the kernel (or raises: there is no fallback);
  * a CPU tensor runs the ``*_plain`` version, the same function in plain
    torch ops. Nothing on the card path calls it; ``chip_smoke.py`` holds the
    kernels against it on the card.

B1 and B2's two passes each have two kernels, chosen by ``on_tensor_cores``:
bf16 runs the tensor-core kernels (``csrc/attention_fwd_mma.cuh``,
``csrc/attention_bwd_mma.cuh``), f32 the CUDA-core kernels, the card's
reference route; a bf16 map past 64x64 also takes the CUDA-core kernels.

Head widths: every attention source (``WIDTH_SOURCES``, both layouts) is
built once per width class (KW, VW) of ``WIDTH_CLASSES`` (``-DATTN_KW``,
``-DATTN_VW``), each class at its first use; ``width_plan`` sends a head of
dkh <= KW, dvh <= VW to the smallest class that holds it, with one chunk of
each head dimension. A head past the largest class, (128, 64), runs in that
class's libraries with nk = ceil(dkh / 128) key chunks and nv = ceil(dvh /
64) value chunks (``csrc/attention_wide.cuh``): the wrappers pass the chunk
counts to every entry, so any dkh >= 1 and dvh >= 1 launches a kernel on a
CUDA tensor; only a width below 1 raises ValueError.

``RelAttention.apply`` is what a model calls: its forward is B1 and its
backward B2, and it returns the packed cotangent d[q ; RW ; RH] whole, so the
pack's own autograd carries dRW/dRH on to q and the relative embeddings (as
the JAX ``aa_attention_pallas`` leaves the pack outside its custom_vjp).
The bare forward wrapper refuses CUDA operands that require grad while grad
mode is on: its output has no ``grad_fn``, so gradients would be dropped.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from chexpert_tpu_torch import kernels
from chexpert_tpu_torch.utils import trace

NAME = "rel_attention_fwd"
BWD_SOURCE = "rel_attention_bwd"  # one source, two kernels (passes)
BWD_DKDV = "rel_attention_bwd_dkdv"
BWD_DQ = "rel_attention_bwd_dq"
# (KW, VW): the padded key / value head widths the attention libraries are
# built for, smallest first (csrc/attention_bwd_mma.cuh ATTN_KW / ATTN_VW)
WIDTH_CLASSES = ((32, 8), (32, 16), (64, 32), (128, 64))
# the sources built once per width class
WIDTH_SOURCES = ("rel_attention_fwd", "rel_attention_bwd", "hil_attention_fwd",
                 "hil_attention_bwd")
MMA_MAX_BIN_TILES = 16  # csrc/attention_bwd_mma.cuh MAX_BIN_TILES
KEY_TILE = 64           # csrc/attention_bwd_mma.cuh TN: keys per row of the key table
# csrc/attention_wide.cuh: the tensor-core backward passes of a head past the
# largest class, whose plan ``wide_bwd_plan`` chooses (tc_plan checks it)
BW_ROWS = 64            # BW_ROWS: own tokens of a block
BW_NTO = 32             # NTO: n8 output tiles a warp holds (pass dkdv; dq with <= 4 bin tiles)
BW_NTO_BINS = 16        # NTO_BINS: pass dq with more bin tiles
BW_SMEM_MAX = 232448    # BW_SMEM_MAX: dynamic shared memory of one block on the H100
BW_WG = 2               # BW_WG: column groups (warp groups of 4 warps) a block holds at most
SM_SMEM = 233472        # shared memory of an H100 SM, 1 KB of it reserved per block
H100_SMS = 132          # SMs of the H100 (SXM), where no card is asked
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BF16_ONE = 0x3F80      # 1.0 in bf16


def width_class(dkh: int, dvh: int) -> Tuple[int, int]:
    """The width class (KW, VW) of WIDTH_CLASSES whose library takes a head
    of these widths: the smallest with dkh <= KW and dvh <= VW, else the
    largest, which takes wider heads in chunks (``width_plan``)."""
    if dkh < 1 or dvh < 1:
        raise ValueError(f"no attention kernel takes dkh={dkh}, dvh={dvh}: head widths "
                         "start at 1")
    return next(((kw, vw) for kw, vw in WIDTH_CLASSES if dkh <= kw and dvh <= vw),
                WIDTH_CLASSES[-1])


def width_plan(dkh: int, dvh: int) -> Tuple[Tuple[int, int], int, int]:
    """(width class, nk, nv): the library of ``width_class`` and the chunks of
    its widths that cover the head, nk = ceil(dkh / KW) and nv = ceil(dvh /
    VW), which the wrappers pass to the entries. (1, 1) for a head the class
    holds; more on either runs ``csrc/attention_wide.cuh``, chunk i of a
    dimension covering its lanes [i * KW, min((i + 1) * KW, dkh)) (VW for
    dvh)."""
    kw, vw = cls = width_class(dkh, dvh)
    return cls, -(-dkh // kw), -(-dvh // vw)


def width_defines(cls: Tuple[int, int]) -> Tuple[str, ...]:
    """The nvcc defines of a width class's libraries."""
    return (f"-DATTN_KW={cls[0]}", f"-DATTN_VW={cls[1]}")


def width_targets() -> list:
    """Every attention library: (source, defines) of each source of
    WIDTH_SOURCES in each width class, for ``kernels.build``."""
    return [(source, width_defines(c)) for source in WIDTH_SOURCES for c in WIDTH_CLASSES]


def width_library(name: str, source: str, dkh: int, dvh: int):
    """The loaded library of ``source`` for the width class of (dkh, dvh),
    built at its first use; a width below 1 raises ValueError naming the
    kernel ``name``."""
    try:
        cls = width_class(dkh, dvh)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return kernels.load(source, width_defines(cls))


def key_positions(hw: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col, row) image coordinates of each key token, row-major."""
    j = torch.arange(hw, device=device)
    return j % W, j // W


def bin_tiles(H: int, W: int) -> int:
    """8-wide tiles of the bins [dRC_w (W) | dRC_h (H)]: columns, then rows."""
    return -(-W // 8) + -(-H // 8)


def on_tensor_cores(dtype, H: int, W: int) -> bool:
    """Whether the attention kernels (the forwards B1 and B5, the backward
    passes dkdv and dq of B2 and B6) run their tensor-core versions for this
    operand dtype and map: bf16, and a number of bin tiles that the backward's
    dq pass is instantiated for (every map up to 64x64). Otherwise the entries
    run the CUDA-core kernels (f32 always does). The same rule is in the
    sources (``amma::mma_fits``); the tensor-core kernels read the key table."""
    return dtype == torch.bfloat16 and bin_tiles(H, W) <= MMA_MAX_BIN_TILES


def bwd_pack(H: int, W: int, dkh: int, dvh: int) -> int:
    """The (batch, head) pairs that one BW_ROWS-token tile of the tensor-core
    backward passes of ``csrc/attention_wide.cuh`` packs: a head past the
    largest width class on a map of at most BW_ROWS / 2 tokens takes
    BW_ROWS // hw (1x1: 64, 2x2: 16, 4x4: 4), anything else 1. Pass dq reads
    the key table of that many copies of the map (``key_table``)."""
    hw = H * W
    if width_plan(dkh, dvh)[1:] == (1, 1) or hw > BW_ROWS // 2:
        return 1
    return BW_ROWS // hw


def _rel_stride(W: int, H: int) -> int:  # csrc/attention_bwd_mma.cuh rel_stride_of
    s = W + H
    return s + ((4 - s % 8) + 8) % 8


def _other_tile(smem: dict, wg: int):
    """The other side's tokens a tile of a tensor-core kernel, of 32 and 16
    whose shared memory ``smem[tk]`` fits: 32, or 16 where that alone lets
    two one-group blocks share an SM; None where neither fits a block."""
    return next((tk for tk in (32, 16) if wg == 1 and 2 * (smem[tk] + 1024) <= SM_SMEM),
                next((tk for tk in (32, 16) if smem[tk] <= BW_SMEM_MAX), None))


def wide_bwd_plan(H: int, W: int, dkh: int, dvh: int, layout: str = "bn") -> dict:
    """The plan of the tensor-core backward passes for a bf16 head past the
    largest width class, chosen here alone: the entries take it
    (``bwd_plan_args``) and csrc/attention_wide.cuh's ``tc_plan`` refuses a
    plan its kernels cannot run, shared memory other than its own count
    included. Per pass the column groups (each a warp group's n8 output
    tiles, dq's over dkh, dkdv's over [dk | dv]), n8 tiles per group, warp
    groups a block (BW_WG where there are several groups: they share the
    block's staged rows), other tokens per tile (tk: 32, or 16 where that
    alone lets two one-group blocks share an SM) and shared memory in bytes;
    None for a pass whose rows do not fit at tk 16 (the CUDA-core passes take
    it), as for a map past ``on_tensor_cores``. ``layout``: "bn" (pass dkdv
    stages bf16 RC lanes of qr) or "hil" (f32 rows of the rc scratch)."""
    hw = H * W
    pack = bwd_pack(H, W, dkh, dvh)
    kp, vp = -(-dkh // 16) * 16, -(-dvh // 16) * 16
    ks, vs, rs = kp + 8, vp + 8, _rel_stride(W, H)
    plan = {"pack": pack, "own_tiles": 1 if pack > 1 else -(-hw // BW_ROWS)}
    for name in ("dq", "dkdv"):
        is_dq = name == "dq"
        tiles = -(-dkh // 8) + (0 if is_dq else -(-dvh // 8))
        cap = BW_NTO if not is_dq or bin_tiles(H, W) <= 4 else BW_NTO_BINS
        groups = -(-tiles // cap)
        rel_bytes = 2 if layout == "bn" else 4
        own = BW_ROWS * (ks + vs) * 2 + BW_ROWS * 16
        plan[name] = None
        if not on_tensor_cores(torch.bfloat16, H, W):
            continue
        smem = {tk: (own + 2 * tk * (ks + vs) * 2 + BW_ROWS * (rs + 2) * 4 if is_dq
                     else own + 2 * tk * ((ks + vs) * 2 + rs * rel_bytes + 8))
                for tk in (32, 16)}
        wg = BW_WG if groups > 1 else 1
        tk = _other_tile(smem, wg)
        if tk is not None:
            plan[name] = {"groups": groups, "tiles": -(-tiles // groups), "warp_groups": wg,
                          "blocks_per_tile": -(-groups // wg), "tk": tk, "smem": smem[tk]}
    return plan


@functools.lru_cache(maxsize=256)
def bwd_plan_args(pass_name: str, dtype, H: int, W: int, dkh: int, dvh: int,
                  layout: str = "bn") -> Tuple[int, int, int, int, int]:
    """The plan that the backward entries take for pass ``pass_name`` ("dq"
    or "dkdv"), after the head's chunk counts: (pack, column groups, warp
    groups a block, tk, shared memory bytes) of ``wide_bwd_plan``, which the
    tensor-core pass runs; all 0 for a head its width class holds, for f32
    or a map past ``on_tensor_cores``, and for a pass whose rows do not fit
    (the CUDA-core passes take those)."""
    if width_plan(dkh, dvh)[1:] == (1, 1) or not on_tensor_cores(dtype, H, W):
        return (0, 0, 0, 0, 0)
    plan = wide_bwd_plan(H, W, dkh, dvh, layout)
    p = plan[pass_name]
    if p is None:
        return (0, 0, 0, 0, 0)
    return (plan["pack"], p["groups"], p["warp_groups"], p["tk"], p["smem"])


# csrc/attention_wide.cuh FWD_NTG / fwd_blocks: the forward's instances, as
# (n8 tiles of out a warp holds, the blocks an SM its launch bounds promise)
FWD_INSTANCES = ((8, 4), (12, 4), (16, 3), (32, 1))
FWD_WIDE_BLOCKS = 2  # the 32-tile instance, one warp group: blocks an SM at its ~240 registers


def _fwd_tiles(H: int, W: int, dkh: int, dvh: int):
    """Of the tensor-core forward for the head: per tk (32, 16), its shared
    memory bytes and the blocks an SM holds (the shared memory and the
    instance's registers, FWD_INSTANCES); its column groups, warp groups,
    and tk as ``wide_bwd_plan`` chooses it (None: the rows do not fit)."""
    kp, vp = -(-dkh // 16) * 16, -(-dvh // 16) * 16
    ks, vs, rs = kp + 8, vp + 8, _rel_stride(W, H)
    tiles = -(-dvh // 8)
    groups = -(-tiles // BW_NTO)
    wg = BW_WG if groups > 1 else 1
    ntg = -(-tiles // groups)
    regs = next((b for n, b in FWD_INSTANCES[:-1] if wg == 1 and ntg <= n),
                FWD_WIDE_BLOCKS if wg == 1 else FWD_INSTANCES[-1][1])
    smem = {tk: BW_ROWS * ks * 2 + BW_ROWS * 16 + 2 * tk * (ks + vs) * 2 + BW_ROWS * rs * 4
            for tk in (32, 16)}
    per_tk = {tk: (smem[tk], min(regs, SM_SMEM // (smem[tk] + 1024))) for tk in smem}
    return per_tk, groups, wg, _other_tile(smem, wg)


def fwd_pack(H: int, W: int, dkh: int, dvh: int, pairs: int, sms: int = H100_SMS) -> int:
    """The (batch, head) pairs that one BW_ROWS-token tile of the tensor-core
    forward of ``csrc/attention_wide.cuh`` packs, of ``pairs`` in all on a
    card of ``sms`` SMs: a head past the largest width class on a map of at
    most BW_ROWS / 2 tokens packs the fewest that let every block of the grid
    be resident at once (one wave: sms x the blocks an SM holds), at most
    BW_ROWS // hw; anything else 1. A block's time hardly grows with its
    pairs and a second wave doubles the call, so at 1x1 with 512 pairs (one
    block an SM) the pack is 4: 128 blocks, faster than 3 a tile in two
    waves (``scripts/ab_attention_torch.py --packs``)."""
    hw = H * W
    if width_plan(dkh, dvh)[1:] == (1, 1) or hw > BW_ROWS // 2:
        return 1
    per_tk, _, _, tk = _fwd_tiles(H, W, dkh, dvh)
    if tk is None:
        return 1
    return max(1, min(BW_ROWS // hw, -(-pairs // (sms * per_tk[tk][1]))))


def wide_fwd_plan(H: int, W: int, dkh: int, dvh: int, pairs: int,
                  sms: int = H100_SMS):
    """The plan of the tensor-core forward for a bf16 head past the largest
    width class over ``pairs`` (batch, head) pairs, chosen here alone: the
    entries take it (``fwd_plan_args``) and csrc/attention_wide.cuh's
    ``tc_plan`` refuses a plan its kernel cannot run, shared memory other
    than its own count included. The pack (``fwd_pack``), the column groups
    of out's n8 tiles (at most BW_NTO a group: one up to dvh 256, two at
    dvh 320), n8 tiles per group, warp groups a block (BW_WG where there are
    several groups), key tokens per tile (tk, as ``wide_bwd_plan`` chooses
    it, or 16 where that alone makes the grid resident at once) and shared
    memory in bytes: the query rows, two key and value tiles (whose room
    first holds the chunks of R that the RC rows are summed from), the f32
    RC rows and the token table; and the blocks an SM holds. None for a map
    past ``on_tensor_cores`` and for rows that do not fit at tk 16 (the
    CUDA-core kernel takes those)."""
    if not on_tensor_cores(torch.bfloat16, H, W):
        return None
    per_tk, groups, wg, tk = _fwd_tiles(H, W, dkh, dvh)
    if tk is None:
        return None
    pack = fwd_pack(H, W, dkh, dvh, pairs, sms)
    own_tiles = 1 if pack > 1 else -(-(H * W) // BW_ROWS)
    blocks = -(-pairs // pack) * own_tiles * -(-groups // wg)
    if tk == 32 and sms * per_tk[32][1] < blocks <= sms * per_tk[16][1]:
        tk = 16
    return {"pack": pack, "own_tiles": own_tiles, "groups": groups,
            "tiles": -(-(-(-dvh // 8)) // groups), "warp_groups": wg,
            "blocks_per_tile": -(-groups // wg), "tk": tk, "smem": per_tk[tk][0],
            "blocks_per_sm": per_tk[tk][1]}


def fwd_instance(plan: dict) -> int:
    """The n8 tiles a warp of the forward's instance holds for a plan of
    ``wide_fwd_plan`` (FWD_INSTANCES: the least that holds its column group,
    the widest for two warp groups), as csrc/attention_wide.cuh::fwd picks
    it."""
    if plan["warp_groups"] > 1:
        return FWD_INSTANCES[-1][0]
    return next(n for n, _ in FWD_INSTANCES if plan["tiles"] <= n)


@functools.lru_cache(maxsize=256)
def fwd_plan_args(dtype, H: int, W: int, dkh: int, dvh: int, pairs: int,
                  sms: int = H100_SMS) -> Tuple[int, int, int, int, int]:
    """The plan that the forward entries take after the head's chunk counts:
    (pack, column groups, warp groups a block, tk, shared memory bytes) of
    ``wide_fwd_plan`` for ``pairs`` (batch, head) pairs on a card of ``sms``
    SMs, which the tensor-core forward runs; all 0 for a head its width class
    holds, for f32 or a map past ``on_tensor_cores``, and for rows that do
    not fit (the CUDA-core kernel takes those)."""
    if width_plan(dkh, dvh)[1:] == (1, 1) or not on_tensor_cores(dtype, H, W):
        return (0, 0, 0, 0, 0)
    p = wide_fwd_plan(H, W, dkh, dvh, pairs, sms)
    if p is None:
        return (0, 0, 0, 0, 0)
    return (p["pack"], p["groups"], p["warp_groups"], p["tk"], p["smem"])


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the forward's plan packs tiny maps by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def key_table(H: int, W: int, device: torch.device, pack: int = 1) -> torch.Tensor:
    """What the tensor-core kernels need to know of each tile of 64 keys (the
    dq passes all of it, the forwards the key positions): an int32 table
    (tiles, words) that depends on the map alone, so it is built once per
    (H, W, device, pack) and kept. ``pack`` > 1 (``bwd_plan_args``,
    ``fwd_plan_args``): the keys are ``pack`` copies of the map's hw tokens
    one after another, key v being token v % hw (one row). Per row (``KeyTable`` in
    csrc/attention_bwd_mma.cuh):

      [4 chunks of 16 keys][bin tiles][32 lanes][2]  the B fragments (b0, b1)
          of mma.m16n8k16 for onehot(16 keys -> 8 bins) in bf16: lane 4g + t
          holds bin 8*tile + g against keys 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1),
          the lower key in the low half; the bin tiles are those of the image
          columns, then those of the image rows
      [4]   per chunk, bit ``tile`` set where its keys touch that bin tile
      [64]  per key, image column | row << 16 (0 past the last key)
    """
    hw, nbw, nbt = H * W, -(-W // 8), bin_tiles(H, W)
    nkeys = pack * hw
    tiles = -(-nkeys // KEY_TILE)
    key = torch.arange(tiles * KEY_TILE)
    col = torch.where(key < nkeys, key % hw % W, -1)
    row = torch.where(key < nkeys, key % hw // W, -1)
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    tile = torch.arange(nbt)
    is_col = tile < nbw
    bins = (torch.where(is_col, tile, tile - nbw) * 8)[:, None] + g[None, :]  # (nbt, 32)
    chunk0 = torch.arange(tiles * (KEY_TILE // 16)) * 16

    def hit(offset):  # (chunks, nbt, 32): does key chunk0 + 2t + offset fall into the lane's bin
        k = chunk0[:, None, None] + 2 * t[None, None, :] + offset
        return (torch.where(is_col[None, :, None], col[k], row[k]) == bins[None]).long()

    frags = torch.stack([hit(0) * _BF16_ONE | hit(1) * (_BF16_ONE << 16),
                         hit(8) * _BF16_ONE | hit(9) * (_BF16_ONE << 16)], dim=-1)
    touched = ((frags != 0).any(-1).any(-1).long() << tile[None, :]).sum(-1)  # (chunks,)
    kpos = torch.where(key < nkeys, col | (row << 16), 0)
    table = torch.cat([frags.reshape(tiles, -1), touched.reshape(tiles, -1),
                       kpos.reshape(tiles, -1)], dim=1)
    return table.to(torch.int32).contiguous().to(device)


def _logits_plain(qr, k, H: int, W: int, dkh: int) -> torch.Tensor:
    """f32 S = q.k^T + RW[:, col(j)] + RH[:, row(j)]; call with autocast off."""
    col, row = key_positions(H * W, W, qr.device)
    qf = qr.float()
    return (torch.bmm(qf[..., :dkh], k.float().transpose(1, 2))
            + qf[..., dkh:dkh + W][..., col] + qf[..., dkh + W:][..., row])


def rel_attention_fwd_plain(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax in f32. Returns (out in v's dtype, lse f32)."""
    with torch.autocast(qr.device.type, enabled=False):
        s = _logits_plain(qr, k, H, W, dkh)
        lse = torch.logsumexp(s, dim=-1)
        out = torch.bmm(torch.exp(s - lse[..., None]), v.float())
    return out.to(v.dtype), lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout * out) in f32, (bn, hw): B2's softmax correction
    (computed outside the kernel, as the JAX host side does in XLA)."""
    return (dout.float() * out.float()).sum(-1)


def _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh):
    """(p, ds) in f32: p = exp(S - lse), ds = p (dout v^T - delta)."""
    p = torch.exp(_logits_plain(qr, k, H, W, dkh) - lse[..., None])
    dp = torch.bmm(dout.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 1 of B2 in plain ops: (dk, dv) in k's / v's dtype."""
    with torch.autocast(qr.device.type, enabled=False):
        p, ds = _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh)
        dv = torch.bmm(p.transpose(1, 2), dout.float())
        dk = torch.bmm(ds.transpose(1, 2), qr[..., :dkh].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 2 of B2 in plain ops: dqr = [ds k ; dRW ; dRH] in qr's dtype, the
    bins summing ds over the keys of one image column / row."""
    bn, hw, _ = qr.shape
    with torch.autocast(qr.device.type, enabled=False):
        _, ds = _ds_plain(qr, k, v, lse, delta, dout, H, W, dkh)
        dq = torch.bmm(ds, k.float())
        ds4 = ds.reshape(bn, hw, H, W)  # key j = row * W + col
        dqr = torch.cat([dq, ds4.sum(2), ds4.sum(3)], dim=-1)
    return dqr.to(qr.dtype)


def rel_attention_bwd_plain(qr, k, v, out, lse, dout, H: int, W: int, dkh: int):
    """The whole backward in plain ops: (dqr, dk, dv)."""
    delta = attention_delta(out, dout)
    dk, dv = rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    return rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H, W, dkh), dk, dv


def _check(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int, W: int, dkh: int):
    if qr.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("qr, k, v must be (B*nh, HW, features)")
    bn, hw, L = qr.shape
    if hw != H * W or L != dkh + W + H:
        raise ValueError(f"qr {tuple(qr.shape)} does not match H={H} W={W} dkh={dkh}")
    if k.shape != (bn, hw, dkh) or v.shape[:2] != (bn, hw):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match qr {tuple(qr.shape)}")
    if not (qr.device == k.device == v.device):
        raise ValueError("qr, k, v must be on one device")


def _check_bwd(qr, v, dout, lse, delta):
    bn, hw, _ = qr.shape
    if dout.shape != v.shape or lse.shape != (bn, hw) or delta.shape != (bn, hw):
        raise ValueError(f"dout {tuple(dout.shape)} / lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} do not match v {tuple(v.shape)}")
    if not (dout.device == lse.device == delta.device == qr.device):
        raise ValueError("all operands must be on one device")


def _kernel_entry(name: str, source: str, operands, f32_operands, dkh: int, dvh: int):
    """Validate what the kernel takes and return its ctypes entry, in the
    library of the width class of (dkh, dvh)."""
    if operands[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {operands[0].device}")
    dt = operands[0].dtype
    if dt not in _DTYPE_SUFFIX or any(t.dtype != dt for t in operands):
        raise ValueError(f"{name}: operands must share one dtype of "
                         f"{list(_DTYPE_SUFFIX)}, got {[t.dtype for t in operands]}")
    if any(t.dtype != torch.float32 for t in f32_operands):
        raise ValueError(f"{name}: lse / delta must be float32")
    if not all(t.is_contiguous() for t in (*operands, *f32_operands)):
        raise ValueError(f"{name}: operands must be contiguous")
    if operands[0].shape[0] > 65535:
        raise ValueError(f"{name}: bn={operands[0].shape[0]} exceeds the grid's y limit")
    return getattr(width_library(name, source, dkh, dvh), f"{name}_{_DTYPE_SUFFIX[dt]}")


def rel_attention_fwd(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      H: int, W: int, dkh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """qr (bn, HW, dkh+W+H) packed [q ; RW ; RH], k (bn, HW, dkh),
    v (bn, HW, dvh) -> (out (bn, HW, dvh) in the operand dtype, lse (bn, HW) f32).
    Not differentiable on the card: use ``RelAttention.apply`` for training."""
    _check(qr, k, v, H, W, dkh)
    if qr.device.type == "cpu":
        return rel_attention_fwd_plain(qr, k, v, H, W, dkh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qr, k, v)):
        raise RuntimeError(f"{NAME}: operands require grad but the raw kernel wrapper has no "
                           "backward; call RelAttention.apply (forward B1, backward B2)")
    bn, hw, _ = qr.shape
    dvh = v.shape[-1]
    fn = _kernel_entry(NAME, NAME, (qr, k, v), (), dkh, dvh)
    out = torch.empty((bn, hw, dvh), dtype=v.dtype, device=qr.device)
    lse = torch.empty((bn, hw), dtype=torch.float32, device=qr.device)
    plan = fwd_plan_args(qr.dtype, H, W, dkh, dvh, bn, sm_count(qr.device))
    tab = key_table(H, W, qr.device, max(plan[0], 1)) if on_tensor_cores(qr.dtype, H, W) else None
    kernels.launch(NAME, fn, [None if t is None else t.data_ptr()
                              for t in (qr, k, v, tab, out, lse)],
                   [bn, hw, H, W, dkh, dvh, *width_plan(dkh, dvh)[1:], *plan], qr.device)
    return out, lse


def rel_attention_bwd_dkdv(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 1 of B2: (dk, dv) in the operand dtype."""
    _check(qr, k, v, H, W, dkh)
    _check_bwd(qr, v, dout, lse, delta)
    if qr.device.type == "cpu":
        return rel_attention_bwd_dkdv_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    bn, hw, _ = qr.shape
    dvh = v.shape[-1]
    fn = _kernel_entry(BWD_DKDV, BWD_SOURCE, (qr, k, v, dout), (lse, delta), dkh, dvh)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernels.launch(BWD_DKDV, fn,
                   [t.data_ptr() for t in (qr, k, v, dout, lse, delta, dk, dv)],
                   [bn, hw, H, W, dkh, dvh, *width_plan(dkh, dvh)[1:],
                    *bwd_plan_args("dkdv", qr.dtype, H, W, dkh, dvh)], qr.device)
    return dk, dv


def rel_attention_bwd_dq(qr, k, v, dout, lse, delta, H: int, W: int, dkh: int):
    """Pass 2 of B2: dqr = [dq ; dRW ; dRH] in the operand dtype."""
    _check(qr, k, v, H, W, dkh)
    _check_bwd(qr, v, dout, lse, delta)
    if qr.device.type == "cpu":
        return rel_attention_bwd_dq_plain(qr, k, v, dout, lse, delta, H, W, dkh)
    bn, hw, _ = qr.shape
    dvh = v.shape[-1]
    fn = _kernel_entry(BWD_DQ, BWD_SOURCE, (qr, k, v, dout), (lse, delta), dkh, dvh)
    dqr = torch.empty_like(qr)
    plan = bwd_plan_args("dq", qr.dtype, H, W, dkh, dvh)
    tab = key_table(H, W, qr.device, max(plan[0], 1)) if on_tensor_cores(qr.dtype, H, W) else None
    kernels.launch(BWD_DQ, fn,
                   [None if t is None else t.data_ptr()
                    for t in (qr, k, v, dout, lse, delta, tab, dqr)],
                   [bn, hw, H, W, dkh, dvh, *width_plan(dkh, dvh)[1:], *plan], qr.device)
    return dqr


def rel_attention_bwd(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, H: int, W: int, dkh: int):
    """B2: (dqr, dk, dv) in the dtypes of (qr, k, v), given the forward's
    out and lse and the output cotangent dout."""
    delta = attention_delta(out, dout)
    dk, dv = rel_attention_bwd_dkdv(qr, k, v, dout, lse, delta, H, W, dkh)
    return rel_attention_bwd_dq(qr, k, v, dout, lse, delta, H, W, dkh), dk, dv


class RelAttention(torch.autograd.Function):
    """out = softmax(S) v with forward B1 and backward B2 (plain versions for
    CPU tensors). Operands share one dtype; the backward runs with autocast
    off and returns each gradient in its operand's dtype."""

    @staticmethod
    def forward(ctx, qr, k, v, H: int, W: int, dkh: int):
        with trace.span("attn.fwd", H=H, W=W, batch_heads=qr.shape[0]):
            out, lse = rel_attention_fwd(qr, k, v, H, W, dkh)
        ctx.save_for_backward(qr, k, v, out, lse)
        ctx.geometry = (H, W, dkh)
        return out

    @staticmethod
    def backward(ctx, dout):
        qr, k, v, out, lse = ctx.saved_tensors
        H, W, _ = ctx.geometry
        with torch.autocast(qr.device.type, enabled=False), \
                trace.span("attn.bwd", H=H, W=W, batch_heads=qr.shape[0]):
            dqr, dk, dv = rel_attention_bwd(qr, k, v, out, lse,
                                            dout.to(v.dtype).contiguous(), *ctx.geometry)
        return dqr, dk, dv, None, None, None
