"""Build and load the hand-written CUDA kernels of ``tpu_sparse_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source
started together, and link into one shared library with a plain C
interface, loaded through ``ctypes``. The build runs at first
use into ``tpu_sparse_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so a fresh checkout builds everything on its first
kernel launch and an edited source rebuilds. Nothing here runs at import:
machines without ``nvcc`` import every module and use the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libtpu_sparse_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
build_seconds: "float | None" = None  # wall time of this process's build


def sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def build_key() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "tpu_sparse_torch build from source at first use")


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed build directory; returns the
    library path. A failed compile raises with nvcc's output."""
    global build_seconds
    out_dir = BUILD_DIR / build_key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    steps = []  # (command, process), all compiles started together
    for src in (p for p in sources() if p.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
               str(work / (src.stem + ".o")), str(src)]
        steps.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in steps:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{err}")
    if not failed:
        tmp = work / LIB_NAME
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *sorted(str(o) for o in work.glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text("".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    p = BUILD_DIR / build_key() / "nvcc.log"
    return p.read_text() if p.exists() else ""


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        # data, ld, offsets, ndiag, x, y, n_rows, n_cols, wl, e, extended, stream
        "ts_dia_spmv_f32": [P, L, P, I, P, P, L, L, L, L, I, P],
        "ts_dia_spmv_f64": [P, L, P, I, P, P, L, L, L, L, I, P],
        "ts_dia_spmv_c64": [P, L, P, I, P, P, L, L, L, L, I, P],
        "ts_dia_spmv_c128": [P, L, P, I, P, P, L, L, L, L, I, P],
        "ts_dia_spmv_bf16": [P, L, P, I, P, P, L, L, L, L, I, P],
        "ts_dia_spmv_bf16_f32": [P, L, P, I, P, P, L, L, L, L, I, P],
        # the first plain-mode design (v1): data, ld, offsets, ndiag, x, y,
        # n_rows, n_cols, stream
        **{f"ts_dia_spmv_v1_{s}": [P, L, P, I, P, P, L, L, P]
           for s in ("f32", "f64", "c64", "c128", "bf16", "bf16_f32")},
        # offsets, ndiag, n_rows, n_cols, ld, data address, build, sms, out
        "ts_dia_spmv_geometry": [P, I, L, L, L, ctypes.c_ulonglong, I, I, P],
        # data, ld, offsets, ndiag, n, wl, r, dinv, p_prev, p_new, ap, scal,
        # pap_part, grid, stream
        "ts_dia_cg_spmv_dot": [P, L, P, I, L, L, P, P, P, P, P, P, P, I, P],
        # n, wl, x, r, p, ap, dinv, pap_part, n_pap, scal, rr_part, gz_part,
        # counter, hist, init, grid, stream
        "ts_dia_cg_update": [L, L, P, P, P, P, P, P, I, P, P, P, P, P, I, I,
                             P],
        # data, ld, offsets, ndiag, n, wl, r, p_prev, q_prev, rhat, p_new,
        # q_new, scal, part, grid, stream
        "ts_dia_bicgstab_q": [P, L, P, I, L, L, P, P, P, P, P, P, P, P, I, P],
        # data, ld, offsets, ndiag, n, wl, r, q, s, t, scal, part, counter,
        # grid, stream
        "ts_dia_bicgstab_t": [P, L, P, I, L, L, P, P, P, P, P, P, P, I, P],
        # n, wl, x, r, p, s, t, rhat, scal, part, counter, hist, init, grid,
        # stream
        "ts_dia_bicgstab_update": [L, L, P, P, P, P, P, P, P, P, P, P, I, I,
                                   P],
        # cvals, idx, srow, boff, x, y, n_blocks, planes, n_rows, wide,
        # stream
        "ts_cwell_spmv_f32": [P, P, P, P, P, P, L, L, L, I, P],
        "ts_cwell_spmv_f64": [P, P, P, P, P, P, L, L, L, I, P],
        "ts_cwell_spmv_c64": [P, P, P, P, P, P, L, L, L, I, P],
        "ts_cwell_spmv_c128": [P, P, P, P, P, P, L, L, L, I, P],
        "ts_cwell_spmv_bf16": [P, P, P, P, P, P, L, L, L, I, P],
        "ts_cwell_spmv_bf16_f32": [P, P, P, P, P, P, L, L, L, I, P],
        # cvals, idx, srow, boff, B, Y, n_blocks, planes, n_rows, k, depth,
        # wide, stream
        "ts_cwell_spmm_f32": [P, P, P, P, P, P, L, L, L, L, L, I, P],
        "ts_cwell_spmm_f64": [P, P, P, P, P, P, L, L, L, L, L, I, P],
        "ts_cwell_spmm_c64": [P, P, P, P, P, P, L, L, L, L, L, I, P],
        "ts_cwell_spmm_c128": [P, P, P, P, P, P, L, L, L, L, L, I, P],
        # cvals, idx, srow, boff, B, Y, work, n_blocks, planes, n_rows, k,
        # depth, wide, stream
        "ts_cwell_spmm_bf16": [P, P, P, P, P, P, P, L, L, L, L, L, I, P],
        "ts_cwell_spmm_bf16_f32": [P, P, P, P, P, P, P, L, L, L, L, L, I, P],
        "ts_cwell_spmm_f32_bf16": [P, P, P, P, P, P, P, L, L, L, L, L, I, P],
        # blocks, indices, B, Y, n_block_rows, L, bs, n_cols, k, stream
        "ts_bell_spmm_f32": [P, P, P, P, L, L, L, L, L, P],
        "ts_bell_spmm_f64": [P, P, P, P, L, L, L, L, L, P],
        "ts_bell_spmm_c64": [P, P, P, P, L, L, L, L, L, P],
        "ts_bell_spmm_c128": [P, P, P, P, L, L, L, L, L, P],
        "ts_bell_spmm_bf16": [P, P, P, P, L, L, L, L, L, P],
        "ts_bell_spmm_bf16_f32": [P, P, P, P, L, L, L, L, L, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ts_error_string.argtypes = [ctypes.c_int]
    lib.ts_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's host entry reported an error."""
    if rc != 0:
        msg = library().ts_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: error {rc} ({msg})")


def int_array(values) -> tuple:
    """A C int array and its address; hold the array while the call runs."""
    arr = (ctypes.c_int * max(len(values), 1))(*values)
    return arr, ctypes.addressof(arr)
