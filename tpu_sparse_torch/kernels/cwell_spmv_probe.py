"""Design probe for K4 / K5 (``csrc/cwell_spmv.cu``) on one GPU.

    python3 -m tpu_sparse_torch.kernels.cwell_spmv_probe [nx]

The kernel source holds two designs, a ring of bulk async copies (K4's,
8 slot rows x 2 stages; 16 x 2 for bf16 values) and plain loads (K5's).
This probe instantiates both for float, double and bf16 values (with a
float x), the ring at 8 x 2, 16 x 2, 4 x 2 and 8 x 4, in one extra
library: a generated file that includes ``cwell_spmv.cu``, compiled with
the package's nvcc flags. It prints their ptxas lines, packs
``poisson3d_27pt(nx)`` (default 160) taken as a general CSR on the card,
builds its row-compact plan, checks every design and the shipped entry
(``cuda_cwell.cwell_spmv_cuda``) in float32, float64 and bf16 values
against ``reference.cwell_compact_spmv`` and the plane reference (1e-5 /
1e-13 / 1e-5 of max|y|; reruns bit-identical) and times them in turns
(each visited twice, in opposite orders) with CUDA events, beside the
cuSPARSE CSR matvec of the same matrix and the bound (the plan's bytes
over 3.35 TB/s). Then it profiles one BiCGStab solve on the CWELL pack
of ``convection_diffusion_3d_27pt(nx)``: the device's busy share and its
time by kernel. Needs nvcc and a CUDA device; it changes nothing in the
package.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

# design: (slot rows a stage, stages); (0, 0) is plain loads
DESIGNS = {"ring 8x2": (8, 2), "ring 16x2": (16, 2), "ring 4x2": (4, 2),
           "ring 8x4": (8, 4), "plain loads": (0, 0)}
# values' and x's C types
_TYPES = {"f32": ("float", "float"), "f64": ("double", "double"),
          "bf16": ("ts_bf16", "float")}


def _symbol(chunk: int, stages: int, sfx: str) -> str:
    return f"probe_cwell_spmv_{chunk}x{stages}_{sfx}"


def build_designs(work: Path) -> "tuple[ctypes.CDLL, list]":
    """The library of every design (narrow indices) and the ptxas lines of
    its cwell kernels."""
    from tpu_sparse_torch.kernels import _build

    src = work / "cwell_spmv_probe.cu"
    lines = ['#include "cwell_spmv.cu"']
    for chunk, stages in DESIGNS.values():
        for sfx, (T, X) in _TYPES.items():
            lines.append(
                f'extern "C" int {_symbol(chunk, stages, sfx)}(const void* v,'
                f" const void* ix, const int* srow, const long long* boff, "
                f"const void* x, void* y, long long nb, long long planes, "
                f"long long n, cudaStream_t s) {{ return launch_cwell_spmv<"
                f"{T}, {X}, unsigned short, {chunk}, {stages}>((const {T}*)"
                f"v, (const unsigned short*)ix, srow, boff, (const {X}*)x, "
                f"({X}*)y, nb, planes, n, s); }}")
    src.write_text("\n".join(lines) + "\n")
    lib = work / "cwell_spmv_probe.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    out = (proc.stdout + proc.stderr).splitlines()
    info = [f"{ln.split(chr(39))[1][:48]}: "
            + next(u for u in out[i:] if "Used" in u).strip()
            for i, ln in enumerate(out)
            if "Compiling entry" in ln and "cwell" in ln]
    loaded = ctypes.CDLL(str(lib))
    P, L = ctypes.c_void_p, ctypes.c_longlong
    for chunk, stages in DESIGNS.values():
        for sfx in _TYPES:
            fn = getattr(loaded, _symbol(chunk, stages, sfx))
            fn.argtypes = [P, P, P, P, P, P, L, L, L, P]
            fn.restype = ctypes.c_int
    return loaded, info


def main(argv) -> int:
    import numpy as np
    import torch

    from tpu_sparse_torch import tracing
    from tpu_sparse_torch.kernels import cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell
    from tpu_sparse_torch.utils.timing import cuda_times_ms

    if not torch.cuda.is_available():
        print("cwell_spmv_probe: no CUDA device", file=sys.stderr)
        return 2
    nx = int(argv[1]) if len(argv) > 1 else 160
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, f"torch {torch.__version__}")
    with tempfile.TemporaryDirectory() as tmp:
        lib, info = build_designs(Path(tmp))
        print("ptxas:\n  " + "\n  ".join(info))

        A = conv.to_csr(gen.poisson3d_27pt(nx, device=dev))
        W = csr_to_cwell(A)
        n, m = W.shape
        tracing.reset()
        packs = {"f32": W, "f64": W.with_data(W.vals.double()),
                 "bf16": W.with_data(W.vals.bfloat16())}
        compacts = {k: cwell_compact.compact(P) for k, P in packs.items()}
        plan = compacts["f32"][0]
        assert not plan.wide
        lens = torch.diff(plan.boff) // 128
        print(f"poisson3d_27pt({nx}) as CSR: n={n} nnz={A.nnz}; pack S="
              f"{W.planes}, {W.vals.numel()} slots (fill {W.fill:.4f}); "
              f"compact plan {plan.slots} slots ({A.nnz / plan.slots:.4f} "
              f"of them entries), L_b {int(lens.min())}-{int(lens.max())}, "
              f"plan {plan.nbytes / 1e6:.1f} MB; counts "
              f"{dict(cwell_compact.COUNTS)}")
        for key, P in packs.items():
            plan, cv = compacts[key]
            dt = torch.float32 if key == "bf16" else P.vals.dtype
            size = P.vals.element_size()
            x = torch.from_numpy(np.random.default_rng(5).standard_normal(
                m)).to(dev, dt)
            y_ref = ref.cwell_compact_spmv(plan, cv, x)
            y_pack = ref.cwell_spmv(P, x)
            tol = 1e-13 if key == "f64" else 1e-5
            scale = float(y_ref.abs().max())
            check = float((y_ref - y_pack).abs().max())
            print(f"{key}: compact reference vs plane reference max abs "
                  f"{check:.2e} (max|y| {scale:.2e})")
            assert check <= tol * scale

            def design(chunk, stages, x=x, plan=plan, cv=cv, key=key, dt=dt):
                fn = getattr(lib, _symbol(chunk, stages, key))

                def call():
                    y = torch.empty(n, dtype=dt, device=dev)
                    rc = fn(cv.data_ptr(), plan.idx.data_ptr(),
                            plan.srow.data_ptr(), plan.boff.data_ptr(),
                            x.data_ptr(), y.data_ptr(), plan.n_blocks,
                            plan.planes, n,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: {rc}")
                    return y
                return call

            calls = {name: design(*cs) for name, cs in DESIGNS.items()}
            calls["shipped entry"] = lambda P=P, x=x: \
                cuda_cwell.cwell_spmv_cuda(P, x)
            outs = {}
            for name, call in calls.items():
                y1, y2 = call(), call()
                torch.cuda.synchronize()
                err = float((y1 - y_ref).abs().max())
                assert err <= tol * scale, (name, key, err)
                assert torch.equal(y1, y2), (name, key, "rerun differs")
                outs[name] = y1
            same = all(torch.equal(y, outs["shipped entry"])
                       for y in outs.values())
            nbytes = (plan.slots * (size + plan.idx.element_size())
                      + plan.boff.numel() * 8 + W.srow.numel() * 4
                      + (n + m) * x.element_size())
            bound = nbytes / 3.35e12 * 1e3
            times = {name: [] for name in calls}
            for name in list(calls) + list(reversed(calls)):
                times[name] += cuda_times_ms(calls[name], warmup=3, reps=5,
                                             inner=20)
            csr = torch.sparse_csr_tensor(A.indptr, A.indices,
                                          A.data.to(dt), size=A.shape)
            t_lib = cuda_times_ms(lambda: torch.mv(csr, x), warmup=3, reps=5,
                                  inner=20)
            print(f"{key}: bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); "
                  f"designs agree bit for bit: {same}")
            for name, ts in times.items():
                med = float(np.median(ts))
                print(f"  {name:24s} {med:.4f} ms (min {min(ts):.4f} max "
                      f"{max(ts):.4f}), {bound / med:.2f} of bound, "
                      f"{A.nnz / (med * 1e-3) / 1e9:.1f} Gnnz/s")
            print(f"  {'cuSPARSE torch.mv (CSR)':24s} "
                  f"{float(np.median(t_lib)):.4f} ms (min {min(t_lib):.4f} "
                  f"max {max(t_lib):.4f})", flush=True)
            del csr
        del compacts, packs
    profile_bicgstab(nx, dev)
    return 0


def profile_bicgstab(nx, dev) -> None:
    """One BiCGStab solve on the CWELL pack of the convection-diffusion
    matrix under torch.profiler: device time by kernel and the device's
    busy share of the solve."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpu_sparse_torch
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    WC = csr_to_cwell(conv.to_csr(gen.convection_diffusion_3d_27pt(
        nx, device=dev)))
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        WC.shape[0]).astype(np.float32)).to(dev)
    bc = ref.cwell_spmv(WC, xt)

    def run():
        return tpu_sparse_torch.solve(WC, bc, method="bicgstab", tol=1e-6,
                                      maxiter=500)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
    wall = t0.elapsed_time(t1)
    dev_us = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev_us[e.key] = us
    busy = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"bicgstab f32 on the {nx}^3 CWELL under torch.profiler: "
          f"{wall:.2f} ms (CUDA events), device busy {busy:.2f} ms "
          f"({busy / wall:.2f} of it); by kernel (ms): " + "; ".join(
              f"{k[:48]} {v / 1e3:.2f}" for k, v in top), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
