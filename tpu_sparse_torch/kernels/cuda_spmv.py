"""DIA (stencil) SpMV on the H100: kernel 1 (``csrc/dia_spmv.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_spmv.py``:

* ``dia_spmv_cuda`` replaces ``dia_spmv_pallas`` (plain SpMV, rows
  bounds-masked), in float32 and float64, and in complex64 and complex128
  (the JAX package solves complex systems natively off the TPU), and on
  bf16 data with a float32 x (y float32) or a bf16 x (y bf16): the data
  streams at 2 bytes a value and is widened in registers, the sum runs in
  float32 (JAX casts bf16 data to x's float32 and runs its float32 kernel;
  with a bf16 x the TPU kernel summed in bf16);
* ``ExtendedStencilOperator`` keeps every solver vector in the halo-extended
  layout ``[0..0 | x | 0..0]`` whose margins stay zero under Krylov vector
  ops, so the SpMV needs no pad or slice per call; float32, float64 and
  bf16 data (the bf16 builds as above);
* ``ExtendedStencilOperatorF64`` takes the place of the double-f32
  ``ExtendedStencilOperatorDF``: the card has native fp64, so it is the
  float64 build of the same kernel, with the same ``matvec64``.

The extended layout needs margins of at least the bandwidth ``w``; here they
are ``w`` rounded up to 32 (the TPU's 1024/chunk rounding came from Mosaic
tiling). Each wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version beside it for CPU tensors; nothing else selects between
them. Launch counts are kept in ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.containers import DIA

MAX_DIAG = 64     # TS_MAX_DIAG in csrc/ts_common.cuh
MARGIN_ALIGN = 32

# Launches of kernel 1, by mode and dtype; counted where the kernel launches.
LAUNCHES = {"dia_spmv_f32": 0, "dia_spmv_f64": 0,
            "dia_spmv_c64": 0, "dia_spmv_c128": 0,
            "dia_spmv_bf16": 0, "dia_spmv_bf16_f32": 0,
            "dia_spmv_ext_f32": 0, "dia_spmv_ext_f64": 0,
            "dia_spmv_ext_bf16": 0, "dia_spmv_ext_bf16_f32": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128",
           torch.bfloat16: "bf16"}
# the builds, by (data dtype, x dtype): each dtype with itself, and bf16
# data with a float32 x
_BUILDS = {**{(d, d): s for d, s in _SUFFIX.items()},
           (torch.bfloat16, torch.float32): "bf16_f32"}
# the extended mode's builds: real (the fused paths never see complex)
_EXT_SUFFIX = ("f32", "f64", "bf16", "bf16_f32")

# The plain mode's shipped design per build, as csrc/dia_spmv.cu's
# TsDiaShipped sets it: (design, rows a thread). "strided": a CTA owns
# BLOCK * R rows, thread t the rows t, t + BLOCK, ...; "vector": thread t
# owns R consecutive rows, each diagonal's read as one vector load.
PLAIN_DESIGNS = {"f32": ("vector", 2), "f64": ("strided", 1),
                 "c64": ("strided", 1), "c128": ("strided", 1),
                 "bf16": ("vector", 2), "bf16_f32": ("vector", 2)}
BLOCK = 256       # TS_BLOCK
_DESIGN_IDS = {"strided": 0, "vector": 1}
_BUILD_IDS = {"f32": 0, "f64": 1, "c64": 2, "c128": 3, "bf16": 4,
              "bf16_f32": 5}
_VALUE_BYTES = {"f32": 4, "f64": 8, "c64": 8, "c128": 16, "bf16": 2,
                "bf16_f32": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def dtype_pairs(builds: dict, suffixes=None) -> str:
    """The (values dtype, operand dtype) pairs of ``builds`` whose suffix is
    in ``suffixes`` (all by default), for error messages."""
    name = lambda d: str(d).replace("torch.", "")  # noqa: E731
    return ", ".join(f"{name(d)} / {name(x)}" for (d, x), s in builds.items()
                     if suffixes is None or s in suffixes)


def _check_operands(data: torch.Tensor, x: torch.Tensor, offsets,
                    x_len: int, what: str, suffixes=tuple(_BUILDS.values())
                    ) -> str:
    if not (data.is_cuda and x.is_cuda):
        raise ValueError(f"{what}: operands must be CUDA tensors")
    if data.device != x.device:
        raise ValueError(f"{what}: data on {data.device}, x on {x.device}")
    sfx = _BUILDS.get((data.dtype, x.dtype))
    if sfx not in suffixes:
        raise TypeError(
            f"{what}: the kernel takes data / x dtypes "
            f"{dtype_pairs(_BUILDS, suffixes)}; got {data.dtype} data and "
            f"a {x.dtype} x")
    if len(offsets) > MAX_DIAG:
        raise ValueError(
            f"{what}: {len(offsets)} diagonals exceed the kernel's "
            f"{MAX_DIAG}")
    if data.dim() != 2 or data.shape[0] != len(offsets):
        raise ValueError(f"{what}: data must be (ndiag, n), got "
                         f"{tuple(data.shape)}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    if x.dim() != 1 or x.shape[0] != x_len:
        raise ValueError(f"{what}: x must have length {x_len}, got "
                         f"{tuple(x.shape)}")
    return sfx


def _launch(sfx, data, offsets, x, y, n_rows, n_cols, wl, e, extended,
            what):
    from tpu_sparse_torch.kernels import _build

    fn = getattr(_build.library(), "ts_dia_spmv_" + sfx)
    offs, offs_ptr = _build.int_array(offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), data.shape[1], offs_ptr, len(offsets),
                x.data_ptr(), y.data_ptr(), n_rows, n_cols, wl, e,
                int(extended), stream)
    _build.check(rc, what)


def interior(offsets, n_rows: int, n_cols: int) -> "tuple[int, int]":
    """The rows [lo, hi) whose every column ``i + o`` lies in [0, n_cols):
    the rows the plain mode sums without tests (all rows when there are
    no diagonals)."""
    if not offsets:
        return 0, n_rows
    lo = min(max(-min(offsets), 0), n_rows)
    return lo, max(min(n_rows, n_cols - max(offsets)), lo)


def vector_fits(sfx: str, rows: int, data_ptr: int, ld: int) -> bool:
    """Whether the vector design can read data's rows ``rows`` at a time
    as one vector of ``min(rows * value bytes, 16)``-byte pieces: the
    pointer and the row length (``ld`` values) aligned to it."""
    vec = min(rows * _VALUE_BYTES[sfx], 16)
    return data_ptr % vec == 0 and ld * _VALUE_BYTES[sfx] % vec == 0


def plain_geometry(sfx: str, offsets, n_rows: int, n_cols: int, ld: int,
                   data_ptr: int, sms: int) -> dict:
    """The plain mode's launch for one call, as the host entry decides it
    (``ts_dia_spmv_geometry``): the interior, rows a thread, design and
    CTAs. The shipped design's R when its loads fit and the grid keeps two
    CTAs a SM; else one row a thread on the strided design (the scalar
    path)."""
    design, rows = PLAIN_DESIGNS[sfx]
    lo, hi = interior(offsets, n_rows, n_cols)
    fits = design != "vector" or vector_fits(sfx, rows, data_ptr, ld)
    if not fits or -(-n_rows // (BLOCK * rows)) < 2 * sms:
        design, rows = "strided", 1
    return dict(lo=lo, hi=hi, grid=-(-n_rows // (BLOCK * rows)), rows=rows,
                design=design)


def plain_geometry_cuda(sfx: str, offsets, n_rows: int, n_cols: int,
                        ld: int, data_ptr: int, sms: int) -> dict:
    """``plain_geometry`` as the kernel library's host entry computes it
    (needs the built library, not a device)."""
    import ctypes

    from tpu_sparse_torch.kernels import _build

    out = (ctypes.c_longlong * 5)()
    offs, offs_ptr = _build.int_array(offsets)
    _build.check(_build.library().ts_dia_spmv_geometry(
        offs_ptr, len(offsets), n_rows, n_cols, ld, data_ptr,
        _BUILD_IDS[sfx], sms, ctypes.addressof(out)), "ts_dia_spmv_geometry")
    design = {v: k for k, v in _DESIGN_IDS.items()}[out[4]]
    return dict(lo=out[0], hi=out[1], grid=out[2], rows=out[3],
                design=design)


def dia_spmv_v1_cuda(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x by kernel 1's first plain-mode design (v1,
    ``csrc/dia_spmv_v1.cuh``): the bit-for-bit reference of the shipped
    design in the card tests and the smoke run. No solver calls it, and
    ``LAUNCHES`` does not count it."""
    from tpu_sparse_torch.kernels import _build

    n, m = A.shape
    data, x = A.data.resolve_conj(), x.resolve_conj()
    sfx = _check_operands(data, x, A.offsets, m, "dia_spmv_v1_cuda")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = getattr(_build.library(), "ts_dia_spmv_v1_" + sfx)
    offs, offs_ptr = _build.int_array(A.offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), data.shape[1], offs_ptr, len(A.offsets),
                x.data_ptr(), y.data_ptr(), n, m, stream)
    _build.check(rc, "dia_spmv_v1_cuda")
    return y


def dia_spmv_cuda(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x by kernel 1 (plain mode) for CUDA operands; y has x's
    dtype. A conjugate view (``t.conj()`` of a complex tensor) is read as
    its values."""
    n, m = A.shape
    data, x = A.data.resolve_conj(), x.resolve_conj()
    sfx = _check_operands(data, x, A.offsets, m, "dia_spmv_cuda")
    if data.shape[1] < n:
        raise ValueError("dia_spmv_cuda: data has fewer columns than rows")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    _launch(sfx, data, A.offsets, x, y, n, m, 0, 0, False, "dia_spmv_cuda")
    LAUNCHES["dia_spmv_" + sfx] += 1
    return y


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: kernel 1 for a CUDA ``x``; its plain version
    (``reference.dia_spmv``) for a CPU ``x``."""
    if x.is_cuda:
        return dia_spmv_cuda(A, x)
    return ref.dia_spmv(A, x)


class ExtendedStencilOperator:
    """Pad-free DIA SpMV on halo-extended vectors.

    Layout: length ``E = Wl + n + Wl`` with ``Wl = roundup(max(w, 1), 32)``;
    the value region is ``[Wl, Wl + n)``. The kernel writes the margins as
    zero, so they stay zero through axpy/scale ops and diagonal scaling by
    ``extend_diag`` vectors (unit margins).
    """

    def __init__(self, A: DIA):
        n, m = A.shape
        if n != m:
            raise ValueError(f"extended operator needs a square matrix, "
                             f"got {A.shape}")
        if not A.offsets:
            raise ValueError("extended operator needs at least one diagonal")
        w = max(max(abs(o) for o in A.offsets), 1)
        if w >= n:
            raise ValueError(f"bandwidth {w} must be below n={n}")
        self.n = n
        self.offsets = A.offsets
        self.Wl = _round_up(w, MARGIN_ALIGN)
        self.E = 2 * self.Wl + n
        self.data = A.data.contiguous()
        self.dtype = A.data.dtype
        self.device = A.data.device

    def extend(self, v: torch.Tensor) -> torch.Tensor:
        out = v.new_zeros(self.E)
        out[self.Wl:self.Wl + self.n] = v
        return out

    def extend_diag(self, d: torch.Tensor) -> torch.Tensor:
        """Extend a diagonal-scaling vector with ones: ``dinv_ext * v``
        keeps zero margins zero, so Jacobi composes with the layout."""
        out = d.new_ones(self.E)
        out[self.Wl:self.Wl + self.n] = d
        return out

    def extract(self, v_ext: torch.Tensor) -> torch.Tensor:
        return v_ext[self.Wl:self.Wl + self.n]

    def apply_plain(self, x_ext: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of the extended kernel (diagonals
        accumulated in offsets order, margins written zero; bf16 data and
        x widened to float32 and y rounded once, as the bf16 builds do)."""
        Wl, n = self.Wl, self.n
        data, x = ref.widen(self.data), ref.widen(x_ext)
        acc = None
        for d, o in enumerate(self.offsets):
            term = data[d] * x[Wl + o:Wl + o + n]
            acc = term if acc is None else acc + term
        y = x_ext.new_zeros(self.E, dtype=acc.dtype)
        y[Wl:Wl + n] = acc
        return y.to(torch.promote_types(self.dtype, x_ext.dtype))

    def apply_cuda(self, x_ext: torch.Tensor) -> torch.Tensor:
        """Kernel 1, extended mode."""
        sfx = _check_operands(self.data, x_ext, self.offsets, self.E,
                              "ExtendedStencilOperator", _EXT_SUFFIX)
        y = torch.empty(self.E, dtype=x_ext.dtype, device=x_ext.device)
        _launch(sfx, self.data, self.offsets, x_ext, y, self.n, self.n,
                self.Wl, self.E, True, "ExtendedStencilOperator")
        LAUNCHES["dia_spmv_ext_" + sfx] += 1
        return y

    def __call__(self, x_ext: torch.Tensor) -> torch.Tensor:
        if x_ext.is_cuda:
            return self.apply_cuda(x_ext)
        return self.apply_plain(x_ext)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Original-space matvec through the extended layout."""
        return self.extract(self(self.extend(x)))


class ExtendedStencilOperatorF64(ExtendedStencilOperator):
    """Float64 extended operator (native fp64 kernel 1), used for the outer
    residuals of mixed-precision refinement and ``precision="full"``."""

    def __init__(self, A: DIA):
        if A.data.dtype != torch.float64:
            raise TypeError(f"ExtendedStencilOperatorF64 needs float64 data, "
                            f"got {A.data.dtype}")
        super().__init__(A)

    def matvec64(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)


def extendable(A: DIA) -> bool:
    """Whether the extended layout takes ``A``: square, at least one
    diagonal, bandwidth below n."""
    n, m = A.shape
    return (n == m and bool(A.offsets)
            and max(abs(o) for o in A.offsets) < n)


def make_extended_operator(A: DIA) -> "ExtendedStencilOperator | None":
    """Extended float32 or bf16 operator (JAX ``make_extended_operator``
    takes both), or None when the matrix does not fit the layout
    (rectangular, no diagonals, bandwidth >= n, neither dtype)."""
    if not extendable(A) or A.data.dtype not in (torch.float32,
                                                 torch.bfloat16):
        return None
    return ExtendedStencilOperator(A)


def make_extended_operator_f64(A: DIA) -> "ExtendedStencilOperatorF64 | None":
    """Extended float64 operator, or None when unsupported."""
    if not extendable(A) or A.data.dtype != torch.float64:
        return None
    return ExtendedStencilOperatorF64(A)
