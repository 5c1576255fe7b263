"""Plain PyTorch sparse kernels: the correctness oracle and the CPU path.

Counterpart of ``tpu_sparse/kernels/reference.py``. ``dia_spmv`` accumulates
the diagonals in ``offsets`` order exactly like the JAX loop; the CSR/COO
versions scatter-add products onto rows; ``cwell_spmv`` gathers x per
slot and sums the planes, ``cwell_compact_spmv`` / ``cwell_compact_spmm``
do the same on a pack's row-compact plan (K4 - K7's layout); the BSR /
BELL versions contract dense blocks with gathered chunks of x. Each
``*_spmm`` is the same function for a dense ``(m, k)`` operand B, column
by column. Every version takes real and complex values alike (the
complex builds of the card's kernels are held against them).

bf16: the CPU route (``dia_spmv``, ``cwell_spmv``, ``bell_spmm``, ...)
computes in the common dtype of the values and the operand, as the JAX
package's XLA path does, so a bf16 matrix with a bf16 operand sums in
bf16 on the CPU; ``cwell_spmv`` / ``cwell_spmm`` widen bf16 values to a
float32 operand's dtype before the gather, as JAX's kernel K4 does (its
XLA reference casts the gathered operand to bf16 instead: ROADMAP R15).
The plain versions of the card's bf16 builds are ``dia_spmv_wide``,
``bell_spmm_wide`` and the compact versions (``cwell_compact_spmv`` /
``cwell_compact_spmm``): bf16 values and operand widened to float32, the
products and sums in float32, the result rounded once to the common
dtype.

The CWELL and BELL versions skip every product whose matrix value is 0,
as the card's kernels do, so a NaN or Inf in x or B reaches only the rows
whose nonzeros gather it. JAX's references (``mode="fill"``) multiply
every padding slot and block; the two agree wherever the operand is
finite.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import BSR, COO, CSR, DIA


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32 (exact), any other tensor as it is: the
    type the card's bf16 builds compute in."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _wide_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The common dtype of a and b, float32 in place of bf16."""
    dt = torch.promote_types(a, b)
    return torch.float32 if dt == torch.bfloat16 else dt


class _NonzeroProduct(torch.autograd.Function):
    """a * b where a != 0, else 0, with the gradient of a * b: the two are
    one function wherever b is finite, so the adjoint's values gradient
    (the vjp of the plain SpMV) is JAX's, padding slots included. For
    complex operands the gradient takes torch's convention (the cotangent
    times the other factor's conjugate), as autograd's own product does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.where(a != 0, a * b, 0)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = ((g * b.conj()).sum_to_size(a.shape)
              if ctx.needs_input_grad[0] else None)
        gb = ((g * a.conj()).sum_to_size(b.shape)
              if ctx.needs_input_grad[1] else None)
        return ga, gb


def _nonzero_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _NonzeroProduct.apply(a, b)


def coo_spmv(A: COO, x: torch.Tensor) -> torch.Tensor:
    prod = A.data * x[A.col.long()]
    out = torch.zeros(A.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, A.row.long(), prod)


def csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    prod = A.data * x[A.indices.long()]
    out = torch.zeros(A.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, A.row_ids().long(), prod)


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_d data[d, i] * x[i + off_d], rows whose column falls
    outside the matrix skipped; diagonals summed in offsets order."""
    n, m = A.shape
    y = None
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, m - o)
        if i1 <= i0:
            continue
        seg = A.data[d, i0:i1] * x[i0 + o:i1 + o]
        contrib = seg.new_zeros(n)
        contrib[i0:i1] = seg
        y = contrib if y is None else y + contrib
    if y is None:
        return x.new_zeros(n)
    return y


def dia_spmv_wide(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """``dia_spmv`` as kernel 1's bf16 builds compute it: bf16 data and x
    widened to float32, the sum in float32, y rounded once to the common
    dtype."""
    out = torch.promote_types(A.data.dtype, x.dtype)
    return dia_spmv(DIA(widen(A.data), A.offsets, A.shape),
                    widen(x)).to(out)


def cwell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y[row] = sum over planes of vals * x[srow * 128 + idx2], where a
    column at or past m gathers 0 (JAX ``mode="fill"``) and a slot of
    value 0 adds 0 whatever x holds. Computed in the common dtype of the
    values and x."""
    n, m = A.shape
    dt = torch.promote_types(A.vals.dtype, x.dtype)
    gc = A.srow[:, :, None].long() * 128 + A.idx2
    x_fill = torch.cat([x, x.new_zeros(1)])  # x_fill[m] = 0
    xg = x_fill[torch.where((gc >= 0) & (gc < m), gc, m)]
    y = torch.sum(_nonzero_product(A.vals.to(dt), xg.to(dt)), dim=1)
    return y.reshape(-1)[:n]


def cwell_compact_spmv(plan, cvals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y = W @ x from W's row-compact plan (``sparse.cwell_compact``) and
    compact values: each row's slots summed one slot row at a time, in
    slot order (K4 / K5's order). Slots of value 0 add nothing, whatever x
    holds at their column. Computed in the common dtype of the values and
    x, a bf16 one widened to float32 and y rounded once (K4's bf16
    builds)."""
    out = torch.promote_types(cvals.dtype, x.dtype)
    cvals = cvals.to(_wide_dtype(cvals.dtype, x.dtype))
    n, m = plan.shape
    nb = plan.n_blocks
    lens = torch.diff(plan.boff) // 128
    depth = int(lens.max()) if nb else 0
    b = torch.repeat_interleave(torch.arange(nb, device=cvals.device),
                                lens * 128, output_size=plan.slots)
    t = torch.arange(plan.slots, device=cvals.device)
    at = (b, (t - plan.boff[b]) // 128, t % 128)
    keep = cvals != 0
    v = cvals.new_zeros((nb, depth, 128)).index_put_(at, cvals)
    c = torch.full((nb, depth, 128), m, dtype=torch.int64,
                   device=cvals.device).index_put_(
        at, torch.where(keep, plan.columns(), m))
    x_fill = torch.cat([x, x.new_zeros(1)]).to(cvals.dtype)  # x_fill[m] = 0
    y = cvals.new_zeros((nb, 128))
    for j in range(depth):
        y += v[:, j] * x_fill[c[:, j]]
    return y.reshape(-1)[:n].to(out)


def cwell_compact_spmm(plan, cvals: torch.Tensor,
                       B: torch.Tensor) -> torch.Tensor:
    """Y = W @ B for a dense (m, k) B from W's row-compact plan and compact
    values (K6 / K7's layout): each row's slots summed one slot row at a
    time, in slot order, as ``cwell_compact_spmv`` sums each column. Slots
    of value 0 add nothing. Computed as ``cwell_compact_spmv`` computes (a
    bf16 value or B widened to float32, Y rounded once); the gathered
    operand holds one slot row: (n_blocks * 128, k)."""
    out = torch.promote_types(cvals.dtype, B.dtype)
    cvals = cvals.to(_wide_dtype(cvals.dtype, B.dtype))
    n, m = plan.shape
    nb, k = plan.n_blocks, B.shape[1]
    lens = torch.diff(plan.boff) // 128
    depth = int(lens.max()) if nb else 0
    b = torch.repeat_interleave(torch.arange(nb, device=cvals.device),
                                lens * 128, output_size=plan.slots)
    t = torch.arange(plan.slots, device=cvals.device)
    at = (b, (t - plan.boff[b]) // 128, t % 128)
    keep = cvals != 0
    v = cvals.new_zeros((nb, depth, 128)).index_put_(at, cvals)
    c = torch.full((nb, depth, 128), m, dtype=torch.int64,
                   device=cvals.device).index_put_(
        at, torch.where(keep, plan.columns(), m))
    B_fill = torch.cat([B, B.new_zeros((1, k))]).to(cvals.dtype)  # row m: 0
    y = cvals.new_zeros((nb, 128, k))
    for j in range(depth):
        y += v[:, j, :, None] * B_fill[c[:, j]]
    return y.reshape(-1, k)[:n].to(out)


def cwell_spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for a CWELL pack and a dense (m, k) B, with the rules of
    ``cwell_spmv``: a column at or past m gathers a row of zeros, a slot of
    value 0 adds 0. The planes are summed one at a time, in order, so the
    gathered operand never holds more than one plane: (n_blocks * 128,
    k). Computed in the common dtype of the values and B."""
    n, m = A.shape
    k = B.shape[1]
    dt = torch.promote_types(A.vals.dtype, B.dtype)
    vals = A.vals.to(dt)
    B_fill = torch.cat([B, B.new_zeros((1, k))]).to(dt)
    y = vals.new_zeros((vals.shape[0], vals.shape[2], k))
    for s in range(vals.shape[1]):
        gc = A.srow[:, s, None].long() * 128 + A.idx2[:, s]  # (nb, 128)
        y += _nonzero_product(vals[:, s, :, None], B_fill[
            torch.where((gc >= 0) & (gc < m), gc, m)])
    return y.reshape(-1, k)[:n]


def coo_spmm(A: COO, B: torch.Tensor) -> torch.Tensor:
    prod = A.data[:, None] * B[A.col.long()]
    out = prod.new_zeros((A.shape[0], B.shape[1]))
    return out.index_add_(0, A.row.long(), prod)


def csr_spmm(A: CSR, B: torch.Tensor) -> torch.Tensor:
    prod = A.data[:, None] * B[A.indices.long()]
    out = prod.new_zeros((A.shape[0], B.shape[1]))
    return out.index_add_(0, A.row_ids().long(), prod)


def dia_spmm(A: DIA, B: torch.Tensor) -> torch.Tensor:
    """Y[i] = sum_d data[d, i] * B[i + off_d], diagonals in offsets order."""
    n, m = A.shape
    k = B.shape[1]
    y = B.new_zeros((n, k), dtype=torch.promote_types(A.data.dtype, B.dtype))
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, m - o)
        if i1 <= i0:
            continue
        y[i0:i1] += A.data[d, i0:i1, None] * B[i0 + o:i1 + o]
    return y


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    bs = A.blocksize
    gathered = x.reshape(-1, bs)[A.indices.long()]  # (nblocks, bs)
    prods = torch.einsum("nij,nj->ni", A.data, gathered)
    out = prods.new_zeros((A.n_block_rows, bs))
    return out.index_add_(0, A.block_row_ids().long(), prods).reshape(-1)


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    bs, k = A.blocksize, B.shape[1]
    gathered = B.reshape(-1, bs, k)[A.indices.long()]  # (nblocks, bs, k)
    prods = torch.einsum("nij,njk->nik", A.data, gathered)
    out = prods.new_zeros((A.n_block_rows, bs, k))
    out.index_add_(0, A.block_row_ids().long(), prods)
    return out.reshape(A.shape[0], k)


def bell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV: per block row, L dense (bs, bs) blocks times the
    gathered chunks of x (padding blocks are zero); a product whose block
    value is 0 adds 0 whatever x holds."""
    return bell_spmm(A, x[:, None]).reshape(-1)


def bell_spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Y[r bs + i] = sum_l blocks[r, l, i, :] @ B[idx[r, l] bs : + bs],
    skipping products whose block value is 0. One block column c at a
    time, so the gathered operand stays one (nbr, L, bs, k) slab."""
    bs, k = A.blocksize, B.shape[1]
    gathered = B.reshape(-1, bs, k)[A.indices.long()]  # (nbr, L, bs, k)
    y = gathered.new_zeros((A.n_block_rows, bs, k),
                           dtype=torch.promote_types(A.blocks.dtype,
                                                     B.dtype))
    for c in range(bs):
        y += _nonzero_product(A.blocks[:, :, :, c, None],  # (nbr, L, bs, 1)
                              gathered[:, :, None, c, :]).sum(1)
    return y.reshape(A.shape[0], k)


def bell_spmm_wide(A, B: torch.Tensor) -> torch.Tensor:
    """``bell_spmm`` as K8's bf16 builds compute it: bf16 blocks and B
    widened to float32, the sums in float32, Y rounded once to B's
    dtype."""
    return bell_spmm(A.with_data(widen(A.blocks)), widen(B)).to(B.dtype)
