"""The row-compact plan of a CWELL pack: the layout that the card's K4 / K5
(``csrc/cwell_spmv.cu``) and K6 / K7 (``csrc/cwell_spmm.cu``) stream.

A CWELL plane gives all 128 rows of a block one 256-column window, so
rows whose entries fall in other windows pad (a third of the slots of the
27-point matrix at 160^3); the window was the TPU's VMEM gather. On the
card a thread gathers x at any column, so the plan keeps only the slots
whose value is nonzero (the pattern ``CWELL.tocsr`` reads off a pack;
dropping a zero slot is exact for finite x) and stores each row block as
sliced ELL with a 128-row slice:

  boff:  (n_blocks + 1,) int64 — first compact slot of each row block;
         block b holds L_b * 128 slots, L_b the most kept slots of its rows
  idx:   (T,) int16 holding 16 unsigned bits (plane << 8) | idx2, so that
         the column is srow[b, plane] * 128 + idx2, when S <= 256 and every
         kept idx2 is below 256; else (``wide``) int32 absolute columns
  src:   (T,) int32 (int64 past 2^31 pack slots) — the flat pack slot of
         each compact slot, -1 in padding: the values gather

Slot j * 128 + l of block b is the j-th kept slot of row b * 128 + l in
plane order, so each row sums in the order the plane-walking kernel
summed it; padding (value 0) follows a row's kept slots. The kernel skips
slots of value 0, so a NaN or Inf in x reaches only the rows whose kept
slots gather it (a padding slot of the pack added 0 * x[srow * 128]).

Plans are cached on the pack's structure (its ``idx2`` and ``srow`` with
their in-place versions), so every ``with_data`` copy shares one; compact
values are cached on the values tensor, so they are gathered once per new
values tensor (a cast, the adjoint's transposed values, an in-place
write). Both caches keep one entry per live tensor, with no size limit,
and drop it when the tensor is freed, so a plan lives as long as its
pack. Values with a nonzero in a slot the plan dropped rebuild the plan;
that is checked once per values tensor, never per SpMV.

The build reads the pack in steps of whole row blocks, about
``BUILD_SLOTS`` slots each, so its temporaries scale with one step and
not with the pack.
"""

from __future__ import annotations

import weakref

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.sparse.cwell import CWELL, LW
from tpu_sparse_torch.utils.opcache import TensorCache

NARROW_PLANES = 256  # planes a 16-bit slot index can name

# Plan builds and value gathers, counted where they happen.
COUNTS = tracing.group("cwell_plan", {"plan_builds": 0, "value_gathers": 0})

BUILD_SLOTS = 1 << 24  # pack slots a step of the plan build reads

_PLANS = TensorCache()   # on W.idx2: the plan
_VALUES = TensorCache()  # on W.vals: (plan, compact values)


def clear_caches() -> None:
    """Drop every cached plan and compact values (their device memory)."""
    _PLANS.clear()
    _VALUES.clear()


class CompactPlan:
    """The structure of a row-compact pack (see the module docstring)."""

    def __init__(self, boff, idx, src, srow, idx2, shape, wide, depth):
        self.boff = boff
        self.idx = idx
        self.src = src
        self.srow = srow
        self.shape = shape
        self.wide = wide
        self.depth = depth  # the most slot rows of a row block
        self._idx2 = weakref.ref(idx2)

    @property
    def n_blocks(self) -> int:
        return int(self.boff.shape[0]) - 1

    @property
    def planes(self) -> int:
        return int(self.srow.shape[1])

    @property
    def slots(self) -> int:
        return int(self.idx.shape[0])

    @property
    def nbytes(self) -> int:
        """Device bytes the plan holds beside the pack (srow is the
        pack's)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.boff, self.idx, self.src))

    def serves(self, W: CWELL) -> bool:
        return (self._idx2() is W.idx2 and self.srow is W.srow
                and self.shape == W.shape)

    def columns(self) -> torch.Tensor:
        """The global column of every compact slot, (T,) int64 (padding
        slots name a column of their block's first plane, or 0)."""
        if self.wide:
            return self.idx.long()
        code = self.idx.long() & 0xFFFF
        b = torch.repeat_interleave(
            torch.arange(self.n_blocks, device=code.device),
            torch.diff(self.boff), output_size=self.slots)
        return self.srow.long()[b, code >> 8] * LW + (code & 0xFF)


def build_plan(W: CWELL) -> CompactPlan:
    """The compact plan of ``W``'s structure, keeping the slots where
    ``W.vals`` is nonzero, by torch ops on the pack's device, in steps of
    whole row blocks. Raises ValueError if a kept slot's column is outside
    [0, m)."""
    nb, S, _ = W.idx2.shape
    n, m = W.shape
    dev = W.idx2.device
    step = max(1, BUILD_SLOTS // max(S * LW, 1))  # row blocks a step
    steps = [(b0, min(b0 + step, nb)) for b0 in range(0, nb, step)]

    def kept(b0, b1):
        mask = W.vals[b0:b1] != 0
        if n < b1 * LW:  # rows past n are not part of the matrix
            mask &= (torch.arange(b0 * LW, b1 * LW, device=dev)
                     < n).view(-1, 1, LW)
        return mask

    # pass 1: L_b, and whether every kept idx2 fits a byte
    L = torch.zeros(nb, dtype=torch.int64, device=dev)
    past_byte = torch.zeros((), dtype=torch.bool, device=dev)
    for b0, b1 in steps:
        mask = kept(b0, b1)
        L[b0:b1] = mask.sum(1).amax(1)
        i2 = W.idx2[b0:b1]
        past_byte |= (mask & ((i2 < 0) | (i2 > 255))).any()
    boff = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    boff[1:] = torch.cumsum(L * LW, 0)
    T = int(boff[-1])
    depth = int(L.max()) if nb else 0
    wide = S > NARROW_PLANES or bool(past_byte)
    idx = torch.zeros(T, dtype=torch.int32 if wide else torch.int16,
                      device=dev)
    src_dt = torch.int32 if nb * S * LW < 1 << 31 else torch.int64
    src = torch.full((T,), -1, dtype=src_dt, device=dev)

    # pass 2: slot j * 128 + l of block b for the j-th kept slot of lane l
    outside = torch.zeros((), dtype=torch.bool, device=dev)
    for b0, b1 in steps:
        mask = kept(b0, b1)
        rank = torch.cumsum(mask, 1, dtype=torch.int32)  # kept so far
        fi = mask.view(-1).nonzero().squeeze(1)  # the step's flat slot
        del mask
        bs = fi // LW  # the step's block * S + plane
        i2 = W.idx2[b0:b1].reshape(-1)[fi]
        col = W.srow[b0:b1].reshape(-1)[bs].long() * LW + i2
        outside |= ((col < 0) | (col >= m)).any()
        if wide:
            code = col.to(torch.int32)
        else:
            code = (bs % S).to(torch.int32) * 256 + i2  # below 2^16
            code = torch.where(code >= 1 << 15, code - (1 << 16),
                               code).to(torch.int16)  # its 16 bits
        del col, i2
        dest = (rank.view(-1)[fi] - 1).long() * LW
        del rank
        dest += boff[b0 + bs // S]
        dest += fi % LW
        del bs
        idx[dest] = code
        src[dest] = (fi + b0 * S * LW).to(src_dt)
        del code, dest, fi
    if bool(outside):
        raise ValueError(
            f"cwell_compact: a nonzero slot of the pack names a column "
            f"outside [0, {m})")
    COUNTS["plan_builds"] += 1
    return CompactPlan(boff, idx, src, W.srow, W.idx2, W.shape, wide, depth)


def gather_values(plan: CompactPlan, vals: torch.Tensor) -> torch.Tensor:
    """The compact values of a pack's ``vals`` under ``plan``: (T,), 0 in
    padding."""
    with torch.no_grad():
        out = vals.reshape(-1).index_select(0, plan.src.clamp_min(0))
        out = out.resolve_conj()  # the kernels read memory, not views
        out.masked_fill_(plan.src < 0, 0)
    COUNTS["value_gathers"] += 1
    return out


def _nonzeros_in_rows(W: CWELL) -> int:
    """Nonzero values of ``W`` in rows below n."""
    n = W.shape[0]
    total = int(torch.count_nonzero(W.vals))
    tail = n - (W.n_blocks - 1) * LW  # rows of the last block in the matrix
    if tail < LW:
        total -= int(torch.count_nonzero(W.vals[-1, :, tail:]))
    return total


def _structure_key(W: CWELL) -> tuple:
    return (id(W.srow), W.srow._version, W.shape)


def compact(W: CWELL) -> "tuple[CompactPlan, torch.Tensor]":
    """(plan, compact values) of ``W``, from the caches when ``W``'s
    structure and values tensor are the ones they were made from."""
    vkey = (id(W.idx2), W.idx2._version) + _structure_key(W)
    hit = _VALUES.get(W.vals, vkey)
    if hit is not None and hit[0].serves(W):
        return hit
    plan = _PLANS.get(W.idx2, _structure_key(W))
    if plan is None or not plan.serves(W):
        plan = build_plan(W)
        _PLANS.put(W.idx2, plan, _structure_key(W))
    cvals = gather_values(plan, W.vals)
    if int(torch.count_nonzero(cvals)) != _nonzeros_in_rows(W):
        # a nonzero in a slot the plan dropped: the pattern changed
        plan = build_plan(W)
        _PLANS.put(W.idx2, plan, _structure_key(W))
        cvals = gather_values(plan, W.vals)
    _VALUES.put(W.vals, (plan, cvals), vkey)
    return plan, cvals


__all__ = ["BUILD_SLOTS", "COUNTS", "CompactPlan", "build_plan",
           "clear_caches", "compact", "gather_values"]
