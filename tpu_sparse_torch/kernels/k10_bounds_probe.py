"""Launch-bounds probe for K10 (``csrc/dia_bicgstab.cu``) on one GPU.

    python3 -m tpu_sparse_torch.kernels.k10_bounds_probe

Builds the kernel library three times from a temporary copy of ``csrc/``,
with the K10 kernels' ``__launch_bounds__`` set to (256, 1) as shipped,
(256) alone, and (256, 8) (32 registers), prints each build's register
counts, and times the three K10 launches and the f32 BiCGStab solve on
``convection_diffusion_3d_27pt(160)`` with each build in turns (shipped,
plain, capped, capped, plain, shipped) with CUDA events. Needs nvcc and a
CUDA device; it changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

SHIPPED = "__launch_bounds__(TS_BLOCK, 1)"
VARIANTS = {"(256, 1) shipped": SHIPPED,
            "(256)": "__launch_bounds__(TS_BLOCK)",
            "(256, 8)": "__launch_bounds__(TS_BLOCK, 8)"}


def build_variant(bounds: str, work: Path) -> "tuple[ctypes.CDLL, str]":
    """The kernel library with the K10 launch bounds replaced, and the
    ptxas register lines of its K10 kernels."""
    from tpu_sparse_torch.kernels import _build

    src = work / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    cu = src / "dia_bicgstab.cu"
    text = cu.read_text()
    if text.count(SHIPPED) != 3:
        raise RuntimeError("dia_bicgstab.cu no longer has three shipped "
                           "launch bounds to replace")
    cu.write_text(text.replace(SHIPPED, bounds))
    lib = work / _build.LIB_NAME
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(src),
           "-o", str(lib), *sorted(str(p) for p in src.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    regs = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "bicgstab" in line:
            used = next(u for u in lines[i:] if "Used" in u)
            regs.append(f"{line.split(chr(39))[1][:30]}: {used.strip()}")
    loaded = ctypes.CDLL(str(lib))
    _build._declare(loaded)
    return loaded, "\n    ".join(regs)


def main() -> int:
    import numpy as np
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch.kernels import _build
    from tpu_sparse_torch.kernels import cuda_bicgstab as cb
    from tpu_sparse_torch.kernels import cuda_spmv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.utils.timing import cuda_time_ms, cuda_times_ms

    if not torch.cuda.is_available():
        raise SystemExit("k10_bounds_probe needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, bounds) in enumerate(VARIANTS.items()):
            work = Path(tmp) / str(i)
            work.mkdir()
            libs[name], regs = build_variant(bounds, work)
            print(f"  {name}:\n    {regs}")
        dev = torch.device("cuda")
        A = gen.convection_diffusion_3d_27pt(160)
        b = A @ torch.from_numpy(np.random.default_rng(0).standard_normal(
            A.shape[0]).astype(np.float32)).to(dev)
        op = cuda_spmv.ExtendedStencilOperator(A)
        bx = op.extend(b)
        order = list(VARIANTS) + list(reversed(VARIANTS))
        for name in order:
            _build._lib = libs[name]
            st = cb.FusedBiCGStabState(op, bx)
            st.run(torch.empty(3, device=dev))  # a mid-solve state
            pk, qk = torch.zeros_like(bx), torch.zeros_like(bx)
            h = torch.zeros(1, device=dev)
            tq = cuda_time_ms(lambda: cb.dia_bicgstab_q(
                op, st.r, st.p[st.cur], st.q[st.cur], st.rhat, pk, qk,
                st.scal, st.part))
            tt = cuda_time_ms(lambda: cb.dia_bicgstab_t(
                op, st.r, qk, st.s, st.t, st.scal, st.part, st.counter))
            tu = cuda_time_ms(lambda: cb.dia_bicgstab_update(
                op, st.x, st.r, pk, st.s, st.t, st.rhat, st.scal, st.part,
                st.counter, h))
            ts = cuda_times_ms(lambda: tpu_sparse_torch.solve(
                A, b, method="bicgstab", tol=1e-6, maxiter=500), warmup=1,
                reps=5, inner=1)
            print(f"  {name:18s} q {tq:.4f} ms  t {tt:.4f} ms  update "
                  f"{tu:.4f} ms  bicgstab_110M median {np.median(ts):.2f} "
                  f"ms (min {min(ts):.2f} max {max(ts):.2f})", flush=True)
            del st
        _build._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
