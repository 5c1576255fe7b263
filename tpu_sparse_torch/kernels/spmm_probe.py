"""Design probe for the SpMM kernels K6 / K7 (``csrc/cwell_spmm.cu``) and
K8 (``csrc/bell_spmm.cu``) on one GPU.

    python3 -m tpu_sparse_torch.kernels.spmm_probe [nx] [bell_nx]

Instantiates, in one extra library (a generated file that includes both
kernel sources, compiled with the package's nvcc flags), the shipped
designs and their variants, and prints their ptxas lines. K6 / K7 on
``poisson3d_27pt(nx)`` (default 160) taken as a general CSR and packed as
CWELL on the card: the shipped design (256 threads, bulk copies), 128
threads and plain loads, at k = 8, 32, 128 in float32 and k = 4 in
float64. K8 on kron(poisson3d_27pt(bell_nx), C8) (default 40) as a BELL
of 8 x 8 blocks: one stage of 24 to 96 KB (bs = 8 unrolled; the shipped
entry takes 96 KB in float32, 64 KB in float64), two stages and any bs,
at k = 8, 32 in float32 and k = 4 in float64; and on
bf16 blocks with a float32 B at k = 8, one stage of 32 to 96 KB beside the
shipped entry and the float32 blocks. Every design
is checked against its plain version (``reference.cwell_compact_spmm`` /
``reference.bell_spmm``; 1e-5 / 1e-12 of max|Y|), reruns are
bit-identical, the designs' agreement with the shipped one is printed
(bit for bit or the largest difference), and K6 / K7's columns are held
to K4 / K5 (``cwell_spmv_cuda``) bit for bit. Then all are timed in turns
(each visited twice, in opposite orders) with CUDA events, beside the
bound (the bytes the function must move over 3.35 TB/s: for K6 / K7 the
plan's, the plane pack's beside it) and a cuSPARSE SpMM (``torch.sparse.mm``
on the CSR) of the same matrix. Needs nvcc and a CUDA device; it changes
nothing in the package.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

# K6 / K7 designs: (threads, bulk copies)
CWELL_DESIGNS = {"shipped: 256 thr, bulk": (256, 1),
                 "128 thr, bulk": (128, 1),
                 "256 thr, plain loads": (256, 0)}
# K8 designs: (stages, bs or 0 for any, stage bytes)
BELL_DESIGNS = {"1 x 96 KB": (1, 8, 98304),
                "1 x 64 KB": (1, 8, 65536),
                "1 x 48 KB": (1, 8, 49152),
                "1 x 24 KB": (1, 8, 24576),
                "2 x 24 KB": (2, 8, 24576),
                "2 x 48 KB": (2, 8, 49152),
                "1 x 48 KB, any bs": (1, 0, 49152)}
_TYPES = {"f32": "float", "f64": "double"}
# K8 on bf16 blocks with a float32 B: one stage of these target bytes
# (bs = 8 unrolled)
BF16_BELL_STAGES = {"bf16 1 x 96 KB": 98304, "bf16 1 x 80 KB": 81920,
                    "bf16 1 x 64 KB": 65536, "bf16 1 x 48 KB": 49152,
                    "bf16 1 x 32 KB": 32768}


def _cwell_symbol(design, sfx):
    return f"probe_cwell_{design[0]}_{design[1]}_{sfx}"


def _bell_symbol(design, sfx):
    return "probe_bell_" + "_".join(map(str, design)) + f"_{sfx}"


def build_designs(work: Path) -> "tuple[ctypes.CDLL, list]":
    """The library of every design and the ptxas lines of its kernels."""
    from tpu_sparse_torch.kernels import _build

    src = work / "spmm_probe.cu"
    lines = ['#include "cwell_spmm.cu"', '#include "bell_spmm.cu"']
    for sfx, T in _TYPES.items():
        for d in CWELL_DESIGNS.values():
            lines.append(
                f'extern "C" int {_cwell_symbol(d, sfx)}(const void* cv, '
                f"const void* ix, const int* srow, const long long* boff, "
                f"const void* B, void* Y, long long nb, long long planes, "
                f"long long n, long long k, long long depth, int wide, "
                f"cudaStream_t s) {{ return launch_cwell_spmm<{T}, {T}, {T}, "
                f"{d[0]}, {'true' if d[1] else 'false'}>((const {T}*)cv, ix, "
                f"srow, boff, (const {T}*)B, ({T}*)Y, nullptr, nb, "
                f"planes, n, k, depth, wide, s); }}")
        for d in BELL_DESIGNS.values():
            lines.append(
                f'extern "C" int {_bell_symbol(d, sfx)}(const void* blk, '
                f"const int* idx, const void* B, void* Y, long long nbr, "
                f"long long L, long long bs, long long m, long long k, "
                f"cudaStream_t s) {{ return launch_bell_spmm<{T}, {T}, {T}, "
                f"{d[0]}, {d[1]}>((const {T}*)blk, idx, (const {T}*)B, "
                f"({T}*)Y, nbr, L, bs, m, k, s, {d[2]}); }}")
    for stage in BF16_BELL_STAGES.values():
        lines.append(
            f'extern "C" int probe_bell_bf16_{stage}(const void* blk, '
            f"const int* idx, const void* B, void* Y, long long nbr, "
            f"long long L, long long bs, long long m, long long k, "
            f"cudaStream_t s) {{ return launch_bell_spmm<ts_bf16, float, "
            f"float, 1, 8>((const ts_bf16*)blk, idx, (const float*)B, "
            f"(float*)Y, nbr, L, bs, m, k, s, {stage}); }}")
    src.write_text("\n".join(lines) + "\n")
    lib = work / "spmm_probe.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    out = (proc.stdout + proc.stderr).splitlines()
    info = [f"{ln.split(chr(39))[1][:60]}: "
            + next(u for u in out[i:] if "Used" in u).strip()
            for i, ln in enumerate(out)
            if "Compiling entry" in ln and "spmm" in ln]
    loaded = ctypes.CDLL(str(lib))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in _TYPES:
        for d in CWELL_DESIGNS.values():
            fn = getattr(loaded, _cwell_symbol(d, sfx))
            fn.argtypes = [P] * 6 + [L] * 5 + [I, P]
            fn.restype = ctypes.c_int
        for d in BELL_DESIGNS.values():
            fn = getattr(loaded, _bell_symbol(d, sfx))
            fn.argtypes = [P] * 4 + [L] * 5 + [P]
            fn.restype = ctypes.c_int
    for stage in BF16_BELL_STAGES.values():
        fn = getattr(loaded, f"probe_bell_bf16_{stage}")
        fn.argtypes = [P] * 4 + [L] * 5 + [P]
        fn.restype = ctypes.c_int
    return loaded, info


def kron_bell(dev, nx, rng, bs=8):
    """kron(poisson3d_27pt(nx), C) as a BELL through
    ``bsr_to_bell(csr_to_bsr(CSR, bs))``, built on the card: the shape of a
    PDE with bs coupled unknowns per grid node. C = Q diag(1 + u) Q^T is
    SPD with eigenvalues in [1, 2) from ``rng``. Returns (BELL, CSR, the
    smallest eigenvalue of C)."""
    import numpy as np
    import torch

    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.cwell import coo_arrays_to_csr

    Qm, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
    C = (Qm * (1.0 + rng.random(bs))) @ Qm.T
    C = (C + C.T) / 2
    lmin = float(np.linalg.eigvalsh(C).min())
    P = conv.to_csr(gen.poisson3d_27pt(nx, device=dev))
    rows, cols = P.row_ids().long(), P.indices.long()
    ii = torch.arange(bs, device=dev)
    R = (rows[:, None, None] * bs + ii[None, :, None]).expand(-1, bs, bs)
    Cc = (cols[:, None, None] * bs + ii[None, None, :]).expand(-1, bs, bs)
    V = P.data[:, None, None] * torch.from_numpy(C.astype(np.float32)).to(
        dev)[None]
    K = coo_arrays_to_csr(R.reshape(-1), Cc.reshape(-1), V.reshape(-1),
                          (P.shape[0] * bs, P.shape[1] * bs))
    del R, Cc, V, rows, cols
    return bsr_to_bell(csr_to_bsr(K, bs)), K, lmin


def cwell_bytes(plan, W, size, k):
    """Bytes K6 / K7 must move on ``plan``: compact values and indices,
    boff, the window rows, B and Y, each once; and those of the plane pack
    (values, idx2, srow, B, Y) for reference."""
    n, m = W.shape
    io = (n + m) * k * size
    compact = (plan.slots * (size + plan.idx.element_size())
               + plan.boff.numel() * 8 + plan.srow.numel() * 4 + io)
    pack = W.vals.numel() * (size + 4) + W.srow.numel() * 4 + io
    return compact, pack


def bell_bytes(A, size, k):
    """Bytes K8 must move: blocks, indices, B and Y, each once."""
    return (A.blocks.numel() * size + A.indices.numel() * 4
            + (A.shape[0] + A.shape[1]) * k * size)


def _time_in_turns(calls, cuda_times_ms):
    import numpy as np

    times = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        times[name] += cuda_times_ms(calls[name], warmup=2, reps=5, inner=5)
    return {name: (float(np.median(ts)), min(ts), max(ts))
            for name, ts in times.items()}


def _agree(outs, ref_name, Y0, tol):
    """Check every design against the plain version and report each one's
    agreement with ``ref_name``."""
    import torch

    scale = float(Y0.abs().max())
    notes = []
    for name, (y1, y2) in outs.items():
        err = float((y1 - Y0).abs().max())
        assert err <= tol * scale, (name, err, scale)
        assert torch.equal(y1, y2), (name, "rerun differs")
        same = torch.equal(y1, outs[ref_name][0])
        d = float((y1 - outs[ref_name][0]).abs().max())
        notes.append(f"{name}: {'bit-equal' if same else f'max diff {d:.2e}'}")
    return "; ".join(notes)


def main(argv) -> int:
    import numpy as np
    import torch

    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell
    from tpu_sparse_torch.utils.timing import cuda_times_ms

    if not torch.cuda.is_available():
        print("spmm_probe: no CUDA device", file=sys.stderr)
        return 2
    nx = int(argv[1]) if len(argv) > 1 else 160
    bell_nx = int(argv[2]) if len(argv) > 2 else 40
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, f"torch {torch.__version__}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fmt(t, bound):
        return (f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f}), "
                f"{bound / t[0]:.2f} of bound")

    with tempfile.TemporaryDirectory() as tmp:
        lib, info = build_designs(Path(tmp))
        print("ptxas:\n  " + "\n  ".join(info), flush=True)

        # ---- K6 / K7 ------------------------------------------------------
        A = conv.to_csr(gen.poisson3d_27pt(nx, device=dev))
        W32 = csr_to_cwell(A)
        n, m = W32.shape
        for key, k in (("f32", 8), ("f32", 32), ("f32", 128), ("f64", 4)):
            W = W32 if key == "f32" else W32.with_data(W32.vals.double())
            dt = W.vals.dtype
            size = W.vals.element_size()
            plan, cv = cwell_compact.compact(W)
            B = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (m, k))).to(dev, dt)

            def design(d, plan=plan, cv=cv, B=B, k=k, key=key, dt=dt):
                fn = getattr(lib, _cwell_symbol(d, key))

                def call():
                    Y = torch.empty((n, k), dtype=dt, device=dev)
                    rc = fn(cv.data_ptr(), plan.idx.data_ptr(),
                            plan.srow.data_ptr(), plan.boff.data_ptr(),
                            B.data_ptr(), Y.data_ptr(), plan.n_blocks,
                            plan.planes, n, k, plan.depth, int(plan.wide),
                            stream())
                    if rc != 0:
                        raise RuntimeError(f"launch failed: {rc}")
                    return Y
                return call

            calls = {name: design(d) for name, d in CWELL_DESIGNS.items()}
            Y0 = ref.cwell_compact_spmm(plan, cv, B)
            outs = {name: (c(), c()) for name, c in calls.items()}
            torch.cuda.synchronize()
            tol = 1e-5 if key == "f32" else 1e-12
            agree = _agree(outs, "shipped: 256 thr, bulk", Y0, tol)
            shipped = outs["shipped: 256 thr, bulk"][0]
            cols = all(torch.equal(shipped[:, j], cuda_cwell.cwell_spmv_cuda(
                W, B[:, j].contiguous())) for j in range(min(k, 8)))
            assert cols, "K6/K7 columns differ from K4/K5"
            del outs, Y0
            nb_c, nb_p = cwell_bytes(plan, W, size, k)
            bound = nb_c / 3.35e12 * 1e3
            times = _time_in_turns(calls, cuda_times_ms)
            csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data.to(dt),
                                          size=A.shape)
            t_lib = _time_in_turns({"lib": lambda: torch.sparse.mm(csr, B)},
                                   cuda_times_ms)["lib"]
            print(f"K6/K7 {key} k={k}: bound {bound:.4f} ms ({nb_c / 1e6:.1f}"
                  f" MB; the plane pack {nb_p / 3.35e12 * 1e3:.4f} ms, "
                  f"{nb_p / 1e6:.1f} MB); columns equal K4/K5 bit for bit: "
                  f"{cols}; {agree}")
            for name, t in times.items():
                print(f"  {name:28s} {fmt(t, bound)}")
            print(f"  {'cuSPARSE torch.sparse.mm':28s} {fmt(t_lib, bound)}",
                  flush=True)
            del csr, B, W
        del W32, A
        torch.cuda.empty_cache()

        # ---- K8 -------------------------------------------------------------
        bell, bell_csr, _ = kron_bell(dev, bell_nx, np.random.default_rng(0))
        for key, k in (("f32", 8), ("f32", 32), ("f64", 4)):
            Ab = bell if key == "f32" else bell.with_data(bell.blocks.double())
            dt = Ab.blocks.dtype
            B = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (Ab.shape[1], k))).to(dev, dt)

            def design(d, Ab=Ab, B=B, k=k, key=key, dt=dt):
                fn = getattr(lib, _bell_symbol(d, key))

                def call():
                    Y = torch.empty((Ab.shape[0], k), dtype=dt, device=dev)
                    rc = fn(Ab.blocks.data_ptr(), Ab.indices.data_ptr(),
                            B.data_ptr(), Y.data_ptr(), Ab.n_block_rows,
                            Ab.ell_width, Ab.blocksize, Ab.shape[1], k,
                            stream())
                    if rc != 0:
                        raise RuntimeError(f"launch failed: {rc}")
                    return Y
                return call

            calls = {name: design(d) for name, d in BELL_DESIGNS.items()}
            calls["shipped (cuda_bell)"] = \
                lambda Ab=Ab, B=B: cuda_bell.bell_spmm_cuda(Ab, B)
            Y0 = ref.bell_spmm(Ab, B)
            outs = {name: (c(), c()) for name, c in calls.items()}
            torch.cuda.synchronize()
            tol = 1e-5 if key == "f32" else 1e-12
            agree = _agree(outs, "shipped (cuda_bell)", Y0, tol)
            del outs, Y0
            nbytes = bell_bytes(Ab, Ab.blocks.element_size(), k)
            bound = nbytes / 3.35e12 * 1e3
            times = _time_in_turns(calls, cuda_times_ms)
            csr = torch.sparse_csr_tensor(bell_csr.indptr, bell_csr.indices,
                                          bell_csr.data.to(dt),
                                          size=bell_csr.shape)
            t_lib = _time_in_turns({"lib": lambda: torch.sparse.mm(csr, B)},
                                   cuda_times_ms)["lib"]
            print(f"K8 {key} k={k}: bound {bound:.4f} ms ({nbytes / 1e6:.1f} "
                  f"MB); {agree}")
            for name, t in times.items():
                print(f"  {name:28s} {fmt(t, bound)}")
            print(f"  {'cuSPARSE torch.sparse.mm':28s} {fmt(t_lib, bound)}",
                  flush=True)
            del csr, B, Ab

        # ---- K8 on bf16 blocks, float32 B: the stage size -----------------
        Ab = bell.with_data(bell.blocks.to(torch.bfloat16))
        k = 8
        B = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (Ab.shape[1], k)).astype(np.float32)).to(dev)

        def bf16_design(stage):
            fn = getattr(lib, f"probe_bell_bf16_{stage}")

            def call():
                Y = torch.empty((Ab.shape[0], k), dtype=torch.float32,
                                device=dev)
                rc = fn(Ab.blocks.data_ptr(), Ab.indices.data_ptr(),
                        B.data_ptr(), Y.data_ptr(), Ab.n_block_rows,
                        Ab.ell_width, Ab.blocksize, Ab.shape[1], k, stream())
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
                return Y
            return call

        calls = {name: bf16_design(st)
                 for name, st in BF16_BELL_STAGES.items()}
        calls["shipped (cuda_bell)"] = lambda: cuda_bell.bell_spmm_cuda(Ab, B)
        Ab32 = Ab.with_data(Ab.blocks.float())  # the same values
        calls["float32 blocks, shipped"] = \
            lambda: cuda_bell.bell_spmm_cuda(Ab32, B)
        Y0 = ref.bell_spmm_wide(Ab, B)
        outs = {name: (c(), c()) for name, c in calls.items()}
        torch.cuda.synchronize()
        agree = _agree(outs, "shipped (cuda_bell)", Y0, 1e-5)
        del outs, Y0
        nbytes = (Ab.blocks.numel() * 2 + Ab.indices.numel() * 4
                  + (Ab.shape[0] + Ab.shape[1]) * k * 4)
        bound = nbytes / 3.35e12 * 1e3
        times = _time_in_turns(calls, cuda_times_ms)
        print(f"K8 bf16 blocks, float32 B, k={k}: bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB); {agree}")
        for name, t in times.items():
            print(f"  {name:28s} {fmt(t, bound)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
