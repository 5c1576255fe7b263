"""Smoke run of the tpu_sparse_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of tpu_sparse_torch/csrc (nvcc, sm_90a, one nvcc per
source), checks each kernel against its plain PyTorch version, and drives
``tpu_sparse_torch.solve`` along two main paths, each with the launch
counters set to 0 just before it and read just after:

* phases (4)-(5): CG on the 27-point 3-D Poisson system at n = 160^3
  (about 110M nonzeros), with and without Jacobi (fused CG kernels 2-3),
  then the float64 'auto' and 'full' paths;
* phase (8): BiCGStab (fused kernel K10) and GMRES(20) (kernel 1) on the
  27-point convection-diffusion system at n = 160^3, then both methods in
  float64 'auto' and 'full' at 64^3; phase (9) differentiates a cg and a
  bicgstab solve on the card (the bicgstab backward runs K10 on A^T) and
  holds the gradients against the CPU's;
* phase (13): the general-structure path, CG / BiCGStab / GMRES(20) on the
  CWELL packs of the same 160^3 systems taken as general CSR (every matvec
  K4, f32), f64 'full' (K5) and 'auto' (K4 inner sweeps, K5 outer
  residuals), the adjoint on a CWELL, and ``reorder="rcm"``. Phase (12)
  checks K4/K5 on edge packs and the card's packer against the CPU's;
  phase (14) times K4/K5 and the CWELL solves beside the DIA ones;
* phase (17): the multi-RHS path, ``solve(A, B)`` with B of 8 columns on
  the same 160^3 CWELL packs (batched CG, block CG with Jacobi, batched
  BiCGStab and GMRES(20): every matvec one K6/K7 launch; f64 'auto' at 4
  columns: K6/K7 in float and double) and on a block-structured BELL,
  kron(poisson3d_27pt(40), C8) with 110.6M stored entries (K8; its
  single-RHS solve runs K4 on the cached CWELL repack), each column held
  against the single-RHS solve of that column. Phases (15)-(16) check K6/K7
  and K8 on edge cases; phase (18) times them beside their bounds, a
  cuSPARSE SpMM and k K4 launches, and the multi-RHS solves beside k
  single-RHS solves.

It checks every kernel again at the shapes the main paths gave it, and
times every kernel and solve beside its plain version with CUDA events
(solves: median and min-max of 5), beside each kernel's bound (bytes over
the card's 3.35 TB/s) and a cuSPARSE CSR matvec (SpMV) or SpMM. Phases
print as they pass; any failed check raises and the exit code is non-zero.
The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.

Needs torch built for CUDA, numpy and nvcc; it imports no JAX. Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
MAIN_NX = 160   # cg_110M: n = 4,096,000, ~109.2M nonzeros
F64_NX = 64

# Kernels that solve() launches in phases (4)-(5), by launch-counter name.
# The float32 plain mode of kernel 1 ("dia_spmv_f32") serves ``A @ x``,
# which solve() does not call; phases (2), (4) and (6) check it apart.
MAIN_PATH_KERNELS = ("dia_spmv_ext_f32", "dia_spmv_f64", "dia_spmv_ext_f64",
                     "dia_cg_spmv_dot", "dia_cg_update")


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def rel_err(y, y0) -> float:
    return float((y - y0).abs().max() / y0.abs().max().clamp_min(1e-300))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    import tpu_sparse_torch
    from tpu_sparse_torch.kernels import (_build, cuda_bell, cuda_bicgstab,
                                          cuda_cg, cuda_cwell, cuda_spmv)
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner,
                                                 jacobi_preconditioner)
    from tpu_sparse_torch.solvers import bicgstab_full, cg_full, gmres_full
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.utils.timing import cuda_time_ms, cuda_times_ms

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    results = {}  # kernel name -> {"max_abs_err", "ms", "plain_ms", ...}

    def note(name, **kw):
        results.setdefault(name, {}).update(kw)

    # ---- (0) device --------------------------------------------------------
    phase("(0) device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- (1) build ---------------------------------------------------------
    phase("(1) build")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s) from {_build.CSRC_DIR.name}/")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  " + line.strip())

    # ---- (2) kernel 1 against its plain version ----------------------------
    phase("(2) kernel 1 (dia_spmv) against the plain version")
    bound = {torch.float32: 1e-5, torch.float64: 1e-13}

    def check_kernel1(label, A, x):
        """Kernel 1 in plain and extended mode against ``reference.dia_spmv``:
        max abs error <= bound * max|y|, extended margins exactly 0.
        Returns (extended operator, extended x, abs err plain, abs err ext).
        """
        y0 = ref.dia_spmv(A, x)
        y1 = cuda_spmv.dia_spmv_cuda(A, x)
        op = cuda_spmv.ExtendedStencilOperator(A)
        xe = op.extend(x)
        ye = op(xe)
        torch.cuda.synchronize()
        scale = float(y0.abs().max())
        e_plain = float((y1 - y0).abs().max())
        e_ext = float((op.extract(ye) - y0).abs().max())
        margin = float(ye[:op.Wl].abs().max() + ye[op.Wl + op.n:].abs().max())
        name = str(x.dtype).replace("torch.", "")
        print(f"  {label:36s} {name}: rel err plain "
              f"{e_plain / max(scale, 1e-300):.2e} ext "
              f"{e_ext / max(scale, 1e-300):.2e}, margins {margin}")
        b_ = bound[x.dtype] * scale
        check(e_plain <= b_ and e_ext <= b_,
              f"kernel 1 disagrees on {label} {name}")
        check(margin == 0.0, f"nonzero extended margins on {label} {name}")
        return op, xe, e_plain, e_ext

    cases = [("tridiagonal(1500)", lambda dt: gen.tridiagonal(1500, dtype=dt)),
             ("poisson2d(40)", lambda dt: gen.poisson2d(40, dtype=dt)),
             ("poisson3d_27pt(13,11,7) n=1001",
              lambda dt: gen.poisson3d_27pt(13, 11, 7, dtype=dt)),
             ("poisson3d_27pt(128)",
              lambda dt: gen.poisson3d_27pt(128, dtype=dt))]
    for label, make in cases:
        for dt in (np.float32, np.float64):
            A = make(dt).to(dev)
            x = torch.from_numpy(
                rng.standard_normal(A.shape[0]).astype(dt)).to(dev)
            check_kernel1(label, A, x)
            del A, x
    torch.cuda.empty_cache()

    # ---- (3) kernels 2-3 against the plain versions ------------------------
    phase("(3) kernels 2-3 (fused CG) against fused_cg_block_reference "
          "and plain cg_full")
    tol3 = 1e-5
    for label, make, slack in (
            ("poisson2d(64)", lambda: gen.poisson2d(64, dtype=np.float32), 1),
            ("poisson3d_27pt(64)", lambda: gen.poisson3d_27pt(64), 2)):
        A = make().to(dev)
        x_true = torch.from_numpy(
            rng.standard_normal(A.shape[0]).astype(np.float32)).to(dev)
        b = ref.dia_spmv(A, x_true)
        bn = float(torch.linalg.vector_norm(b))
        for jac in (False, True):
            dinv = jacobi_preconditioner(A).dinv if jac else None
            op = cuda_spmv.ExtendedStencilOperator(A)
            # one K-block from a fresh start, kernels vs plain block
            K = 16
            b_ext = op.extend(b)
            d_ext = None if dinv is None else op.extend_diag(dinv)
            st = cuda_cg.FusedCGState(op, b_ext, d_ext)
            hist = torch.empty(K, dtype=torch.float32, device=dev)
            st.run(hist)
            p0 = b_ext if d_ext is None else d_ext * b_ext
            xr, rr, _, hr = cuda_cg.fused_cg_block_reference(
                op, torch.zeros_like(b_ext), b_ext, p0, K, dinv=d_ext)
            ex, eh = rel_err(st.x, xr), rel_err(hist, hr)
            check(ex <= 1e-3 and eh <= 1e-3,
                  f"fused block disagrees on {label}: x {ex}, hist {eh}")
            # whole solves: fused kernels vs plain cg_full
            xg, ig, itg, _ = cuda_cg.fused_cg_ext(op, b, tol=tol3,
                                                  maxiter=2000, dinv=dinv)
            M = None if dinv is None else DiagonalPreconditioner(dinv)
            xp, ip, itp, _ = cg_full(lambda v: ref.dia_spmv(A, v), b,
                                     tol=tol3, maxiter=2000, M=M)
            true_res = float(torch.linalg.vector_norm(
                b - ref.dia_spmv(A, xg)))
            print(f"  {label:20s} jacobi={jac!s:5s}: block rel err x {ex:.1e}"
                  f" hist {eh:.1e}; iters fused {int(itg)} plain {int(itp)};"
                  f" info {int(ig)}/{int(ip)}; true rel res "
                  f"{true_res / bn:.2e}")
            check(abs(int(itg) - int(itp)) <= slack,
                  f"iteration counts differ on {label}")
            check(int(ig) == int(ip) == 0, f"info differs on {label}")
            check(true_res <= 10 * tol3 * bn,
                  f"true residual above the contract on {label}")
        del A, b, x_true, op, st
    torch.cuda.empty_cache()

    # ---- (4) main path: 110M-nnz CG through solve() ------------------------
    phase(f"(4) main path: solve() on poisson3d_27pt({MAIN_NX}), f32")
    A = gen.poisson3d_27pt(MAIN_NX).to(dev)
    n = A.shape[0]
    x_true = torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(dev)
    print(f"  n={n} nnz={A.nnz} DIA data {A.data.numel() * 4 / 1e6:.1f} MB")
    A64 = gen.poisson3d_27pt(F64_NX, dtype=np.float64).to(dev)
    x64_true = torch.from_numpy(rng.standard_normal(A64.shape[0])).to(dev)
    # The smoke's own right-hand sides, built before the main-path run.
    # ``A @ x`` is kernel 1 in plain mode; solve() itself never launches the
    # float32 plain mode, so these launches are checked here and not
    # counted as main-path launches.
    before = dict(cuda_spmv.LAUNCHES)
    b = A @ x_true
    b64 = A64 @ x64_true
    torch.cuda.synchronize()
    rhs_launches = {k: cuda_spmv.LAUNCHES[k] - before[k] for k in before}
    print(f"  right-hand sides b = A @ x_true: kernel-1 launches "
          f"{rhs_launches} (set-up, not counted below)")
    check(rhs_launches["dia_spmv_f32"] == 1
          and rhs_launches["dia_spmv_f64"] == 1,
          "A @ x did not run kernel 1 in plain mode")
    # the main-path run starts here: every launch from now to the end of
    # phase (5) counts
    cuda_spmv.reset_launch_counts()
    cuda_cg.reset_launch_counts()
    solves = {}
    for M in (None, "jacobi"):
        before = {**cuda_spmv.LAUNCHES, **cuda_cg.LAUNCHES}
        t0 = time.perf_counter()
        x, res = tpu_sparse_torch.solve(A, b, method="cg", tol=1e-6,
                                        maxiter=500, M=M)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = {**cuda_spmv.LAUNCHES, **cuda_cg.LAUNCHES}
        grew = {k: after[k] - before[k] for k in after}
        err = float(torch.linalg.vector_norm(x - x_true)
                    / torch.linalg.vector_norm(x_true))
        print(f"  M={M}: {res}; first-call wall {wall * 1e3:.1f} ms; "
              f"rel error to x_true {err:.2e}; launches {grew}")
        check(res.converged, f"main-path solve M={M} did not converge")
        check(res.residual <= 1e-5, f"main-path residual {res.residual}")
        check(grew["dia_cg_spmv_dot"] > 0 and grew["dia_cg_update"] > 0,
              "fused CG kernels did not carry the solve")
        check(grew["dia_spmv_ext_f32"] > 0,
              "kernel 1 did not carry the true-residual check")
        solves[M] = res.iterations

    # ---- (5) f64 paths -----------------------------------------------------
    phase(f"(5) f64 paths on poisson3d_27pt({F64_NX}, float64)")
    for precision in ("auto", "full"):
        before = cuda_spmv.LAUNCHES["dia_spmv_ext_f64"]
        x64, res = tpu_sparse_torch.solve(A64, b64, method="cg", tol=1e-8,
                                          precision=precision)
        err = float(torch.linalg.vector_norm(x64 - x64_true)
                    / torch.linalg.vector_norm(x64_true))
        grew = cuda_spmv.LAUNCHES["dia_spmv_ext_f64"] - before
        print(f"  precision={precision}: {res}; rel error to x_true "
              f"{err:.2e}; fp64 kernel-1 launches {grew}")
        check(res.converged, f"f64 {precision} solve did not converge")
        check(res.residual <= 1e-8, f"f64 {precision} residual")
        check(grew > 0, f"fp64 kernel 1 did not carry precision={precision}")
    main_launches = {**cuda_spmv.LAUNCHES, **cuda_cg.LAUNCHES}
    print(f"  launches in the main-path run (phases 4-5): {main_launches}")
    for k in MAIN_PATH_KERNELS:
        check(main_launches[k] > 0,
              f"kernel {k} was not launched on the main path")

    # ---- (6) times and main-path-shape comparisons -------------------------
    phase("(6) times (CUDA events, median ms per call) and kernel errors at "
          "the main-path shapes")
    # kernel 1 at the shapes the main path gave it: f32 at n = 160^3, fp64
    # at n = 64^3; then fp64 at 160^3, where the f64 solves are timed too
    def note_kernel1(key, A_, x_, label):
        op_, xe_, e_plain, e_ext = check_kernel1(label, A_, x_)
        note(f"dia_spmv_{key}", max_abs_err=e_plain,
             ms=cuda_time_ms(lambda: cuda_spmv.dia_spmv_cuda(A_, x_)),
             plain_ms=cuda_time_ms(lambda: ref.dia_spmv(A_, x_)))
        note(f"dia_spmv_ext_{key}", max_abs_err=e_ext,
             ms=cuda_time_ms(lambda: op_.apply_cuda(xe_)),
             plain_ms=cuda_time_ms(lambda: op_.apply_plain(xe_)))
        return op_

    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    op = note_kernel1("f32", A, x, f"poisson3d_27pt({MAIN_NX}) main path")
    x64 = torch.from_numpy(rng.standard_normal(A64.shape[0])).to(dev)
    note_kernel1("f64", A64, x64, f"poisson3d_27pt({F64_NX}) main path")
    A64L = gen.poisson3d_27pt(MAIN_NX, dtype=np.float64).to(dev)
    x64L_true = torch.from_numpy(rng.standard_normal(n)).to(dev)
    b64L = A64L @ x64L_true
    note_kernel1(f"f64_{MAIN_NX}cubed", A64L,
                 torch.from_numpy(rng.standard_normal(n)).to(dev),
                 f"poisson3d_27pt({MAIN_NX}) float64")

    # kernels 2 and 3 on a mid-solve state, each against its plain version
    bx = op.extend(b)
    for jac in (False, True):
        d_ext = (op.extend_diag(jacobi_preconditioner(A).dinv) if jac
                 else None)
        st = cuda_cg.FusedCGState(op, bx, d_ext)
        st.run(torch.empty(3, dtype=torch.float32, device=dev))
        pl_ = {k: v.clone() for k, v in dict(
            x=st.x, r=st.r, p0=st.p[st.cur], ap=st.ap, scal=st.scal,
            pap=st.pap_part, rr=st.rr_part).items()}
        gz = None if st.gz_part is None else st.gz_part.clone()
        pn_k, pn_p = torch.zeros_like(bx), torch.zeros_like(bx)
        ap_p = torch.zeros_like(bx)
        cuda_cg.dia_cg_spmv_dot(op, st.r, d_ext, st.p[st.cur], pn_k, st.ap,
                                st.scal, st.pap_part)
        cuda_cg.dia_cg_spmv_dot_plain(op, pl_["r"], d_ext, pl_["p0"], pn_p,
                                      ap_p, pl_["scal"], pl_["pap"])
        torch.cuda.synchronize()
        e2 = max(float((pn_k - pn_p).abs().max()),
                 float((st.ap - ap_p).abs().max()))
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        h_k = torch.zeros(1, dtype=torch.float32, device=dev)
        h_p = torch.zeros(1, dtype=torch.float32, device=dev)
        cuda_cg.dia_cg_update(op, st.x, st.r, pn_k, st.ap, d_ext,
                              st.pap_part, st.scal, st.rr_part, st.gz_part,
                              st.counter, h_k)
        cuda_cg.dia_cg_update_plain(op, pl_["x"], pl_["r"], pn_p, ap_p,
                                    d_ext, pl_["pap"], pl_["scal"],
                                    pl_["rr"], gz, cnt, h_p)
        torch.cuda.synchronize()
        e3 = max(float((st.x - pl_["x"]).abs().max()),
                 float((st.r - pl_["r"]).abs().max()))
        eh = abs(float(h_k) - float(h_p)) / max(abs(float(h_p)), 1e-30)
        print(f"  jacobi={jac}: kernel 2 max abs err {e2:.2e}; kernel 3 "
              f"max abs err {e3:.2e}, rel err ||r||^2 {eh:.2e}")
        scale = float(st.x.abs().max() + st.r.abs().max())
        check(e2 <= 1e-4 * float(bx.abs().max()) and e3 <= 1e-4 * scale
              and eh <= 1e-4,
              "fused CG kernels disagree with the plain versions")
        key = "" if not jac else "_jacobi"
        note("dia_cg_spmv_dot" + key, max_abs_err=e2,
             ms=cuda_time_ms(lambda: cuda_cg.dia_cg_spmv_dot(
                 op, st.r, d_ext, st.p[st.cur], pn_k, st.ap, st.scal,
                 st.pap_part)),
             plain_ms=cuda_time_ms(lambda: cuda_cg.dia_cg_spmv_dot_plain(
                 op, st.r, d_ext, st.p[st.cur], pn_p, ap_p, st.scal,
                 pl_["pap"])))
        note("dia_cg_update" + key, max_abs_err=e3,
             ms=cuda_time_ms(lambda: cuda_cg.dia_cg_update(
                 op, st.x, st.r, pn_k, st.ap, d_ext, st.pap_part, st.scal,
                 st.rr_part, st.gz_part, st.counter, h_k)),
             plain_ms=cuda_time_ms(lambda: cuda_cg.dia_cg_update_plain(
                 op, pl_["x"], pl_["r"], pn_p, ap_p, d_ext, pl_["pap"],
                 pl_["scal"], pl_["rr"], gz, cnt, h_p)))
        del st

    # device stream bandwidth (triad a = b + s*c over 3 x 1 GiB)
    m = 1 << 28
    ta, tb, tc = (torch.empty(m, dtype=torch.float32, device=dev)
                  for _ in range(3))
    tb.fill_(1.0)
    tc.fill_(2.0)
    t_triad = cuda_time_ms(lambda: torch.add(tb, tc, alpha=3.0, out=ta))
    triad_gbs = 3 * 4 * m / (t_triad * 1e-3) / 1e9
    del ta, tb, tc
    spmv_ms = results["dia_spmv_ext_f32"]["ms"]
    spmv_bytes = 4 * (A.data.shape[0] + 2) * n
    print(f"  stream triad {triad_gbs:.1f} GB/s; extended f32 SpMV at n={n}:"
          f" {A.nnz / (spmv_ms * 1e-3) / 1e9:.2f} Gnnz/s, "
          f"{spmv_bytes / (spmv_ms * 1e-3) / 1e9:.1f} GB/s "
          f"({spmv_bytes / (spmv_ms * 1e-3) / 1e9 / triad_gbs:.3f} of triad)")
    for k, v in results.items():
        print(f"  {k:24s} kernel {v['ms']:.4f} ms   plain {v['plain_ms']:.4f}"
              f" ms   max abs err {v['max_abs_err']:.2e}")

    # solves beside their plain versions (plain cg_full over the plain SpMV);
    # median and min-max of 5 device-timed runs each
    def solve_ms(fn):
        ts = cuda_times_ms(fn, warmup=1, reps=5, inner=1)
        return float(np.median(ts)), min(ts), max(ts)

    def plain_cg(AA, bb, tol, M=None, maxiter=None):
        return cg_full(lambda v: ref.dia_spmv(AA, v), bb, tol=tol,
                       maxiter=maxiter, M=M)

    jac_A = jacobi_preconditioner(A)
    rows = [
        ("cg f32 M=None (fused)", lambda: tpu_sparse_torch.solve(
            A, b, tol=1e-6, maxiter=500)[1].iterations,
         lambda: int(plain_cg(A, b, 1e-6, maxiter=500)[2])),
        ("cg f32 M=jacobi (fused)", lambda: tpu_sparse_torch.solve(
            A, b, tol=1e-6, maxiter=500, M="jacobi")[1].iterations,
         lambda: int(plain_cg(A, b, 1e-6, jac_A, maxiter=500)[2])),
        ("cg f64 full (fp64 kernel 1)", lambda: tpu_sparse_torch.solve(
            A64, b64, tol=1e-8, precision="full")[1].iterations,
         lambda: int(plain_cg(A64, b64, 1e-8)[2])),
        ("cg f64 auto (refinement)", lambda: tpu_sparse_torch.solve(
            A64, b64, tol=1e-8)[1].iterations, None),
        (f"cg f64 full {MAIN_NX}^3", lambda: tpu_sparse_torch.solve(
            A64L, b64L, tol=1e-8, precision="full")[1].iterations,
         lambda: int(plain_cg(A64L, b64L, 1e-8)[2])),
        (f"cg f64 auto {MAIN_NX}^3", lambda: tpu_sparse_torch.solve(
            A64L, b64L, tol=1e-8)[1].iterations, None),
    ]

    def fmt(t):
        med, lo, hi = t
        return f"{med:9.2f} ms (min {lo:.2f} max {hi:.2f})"

    for label, fn, plain in rows:
        ms = solve_ms(fn)
        pms = solve_ms(plain) if plain is not None else None
        its = fn()
        pits = plain() if plain is not None else None
        print(f"  solve {label:30s} {fmt(ms)} {its} it;   plain "
              + (f"{fmt(pms)} {pits} it" if pms is not None
                 else "not measured (no plain refinement loop)"),
              flush=True)

    A_cg, A64_cg = A, A64   # kernel 1 was timed on these
    b_cg = b                # cg_110M's right-hand side, for phase (13)
    del A64L, b64L, x64L_true
    torch.cuda.empty_cache()
    main_runs = {"phases (4)-(5)": main_launches}

    def counts():
        return {**cuda_spmv.LAUNCHES, **cuda_cg.LAUNCHES,
                **cuda_bicgstab.LAUNCHES, **cuda_cwell.LAUNCHES,
                **cuda_bell.LAUNCHES}

    def reset_counts():
        for mod in (cuda_spmv, cuda_cg, cuda_bicgstab, cuda_cwell,
                    cuda_bell):
            mod.reset_launch_counts()

    # ---- (7) K10 against the plain versions --------------------------------
    phase("(7) K10 (fused BiCGStab) against fused_bicgstab_block_reference "
          "and plain bicgstab_full")
    rng7 = np.random.default_rng(SEED + 7)
    A = gen.poisson2d(64, dtype=np.float32)
    data = A.data.clone()
    data[A.offsets.index(-1)] *= 1.3   # upwind skew: nonsymmetric
    data[A.offsets.index(1)] *= 0.7
    A = A.with_data(data)
    b = ref.dia_spmv(A, torch.from_numpy(
        rng7.standard_normal(A.shape[0]).astype(np.float32)).to(dev))
    op = cuda_spmv.ExtendedStencilOperator(A)
    bx = op.extend(b)
    K = 12
    st = cuda_bicgstab.FusedBiCGStabState(op, bx)
    hist = torch.empty(K, dtype=torch.float32, device=dev)
    st.run(hist)
    xr, _, _, hr = cuda_bicgstab.fused_bicgstab_block_reference(
        op, torch.zeros_like(bx), bx, bx, bx, K)
    ex, eh = rel_err(st.x, xr), rel_err(hist, hr)
    # f32 dot products (plain) against double partials (kernels): the
    # BiCGStab recurrence amplifies the difference in r and p as it
    # converges, so x and the history carry the bound, as for kernels 2-3
    check(ex <= 1e-3 and eh <= 1e-3,
          f"K10 block disagrees: x {ex}, hist {eh}")
    xg, ig, itg, _ = cuda_bicgstab.fused_bicgstab_ext(op, b, tol=1e-5,
                                                      maxiter=2000)
    xp, ip, itp, _ = bicgstab_full(lambda v: ref.dia_spmv(A, v), b,
                                   tol=1e-5, maxiter=2000)
    true_res = float(torch.linalg.vector_norm(b - ref.dia_spmv(A, xg))
                     / torch.linalg.vector_norm(b))
    print(f"  skewed poisson2d(64): block rel err x {ex:.1e} hist {eh:.1e};"
          f" iters fused {int(itg)} plain {int(itp)}; info {int(ig)}/"
          f"{int(ip)}; true rel res {true_res:.2e}")
    check(abs(int(itg) - int(itp)) <= 2, "K10 iteration count differs")
    check(int(ig) == int(ip) == 0, "K10 info differs")
    check(true_res <= 1e-4, "K10 true residual above the contract")
    del A, b, op, bx, st

    # ---- (8) nonsymmetric main path: BiCGStab and GMRES through solve() ----
    phase(f"(8) main path: solve(method='bicgstab' | 'gmres') on "
          f"convection_diffusion_3d_27pt({MAIN_NX}), f32; then f64 at "
          f"{F64_NX}^3")
    rng8 = np.random.default_rng(SEED)
    A = gen.convection_diffusion_3d_27pt(MAIN_NX)
    n = A.shape[0]
    x_true = torch.from_numpy(
        rng8.standard_normal(n).astype(np.float32)).to(dev)
    b = A @ x_true
    A64 = gen.convection_diffusion_3d_27pt(F64_NX, dtype=np.float64)
    x64_true = torch.from_numpy(rng8.standard_normal(A64.shape[0])).to(dev)
    b64 = A64 @ x64_true
    torch.cuda.synchronize()
    print(f"  n={n} nnz={A.nnz} DIA data {A.data.numel() * 4 / 1e6:.1f} MB")
    reset_counts()   # the main-path run of this slice starts here
    nonsym = {}
    for method, kw, carriers in (
            ("bicgstab", {}, ("dia_bicgstab_q", "dia_bicgstab_t",
                              "dia_bicgstab_update")),
            ("gmres", dict(restart=20), ("dia_spmv_ext_f32",))):
        before = counts()
        x, res = tpu_sparse_torch.solve(A, b, method=method, tol=1e-6,
                                        maxiter=500, **kw)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        true_rel = float(torch.linalg.vector_norm(b - ref.dia_spmv(A, x))
                         / torch.linalg.vector_norm(b))
        print(f"  {method}: {res}; true rel res {true_rel:.2e}; launches "
              f"{grew}")
        check(res.converged, f"{method} main-path solve did not converge")
        check(true_rel <= 1e-5, f"{method} true residual {true_rel}")
        check(all(grew.get(k, 0) > 0 for k in carriers),
              f"{method}: {carriers} did not carry the solve")
        nonsym[method] = res.iterations
    for method in ("bicgstab", "gmres"):
        for precision in ("auto", "full"):
            before = counts()
            x64, res = tpu_sparse_torch.solve(A64, b64, method=method,
                                              tol=1e-8, precision=precision)
            grew = counts()["dia_spmv_ext_f64"] - before["dia_spmv_ext_f64"]
            err = float(torch.linalg.vector_norm(x64 - x64_true)
                        / torch.linalg.vector_norm(x64_true))
            print(f"  {method} f64 precision={precision}: {res}; rel error "
                  f"to x_true {err:.2e}; fp64 kernel-1 launches {grew}")
            check(res.converged and res.residual <= 1e-8,
                  f"{method} f64 {precision} did not converge")
            check(grew > 0, f"fp64 kernel 1 did not carry {method} "
                  f"{precision}")
    main_runs["phase (8)"] = counts()
    print("  launches in the main-path run (phase 8): "
          f"{main_runs['phase (8)']}")

    # ---- (9) the adjoint on the card ---------------------------------------
    phase("(9) adjoint: x.sum() backward through solve() on the card "
          "against the CPU")
    rng9 = np.random.default_rng(SEED + 9)
    reset_counts()
    for method, make in (("cg", gen.poisson3d_27pt),
                         ("bicgstab", gen.convection_diffusion_3d_27pt)):
        Ac = make(32, device="cpu")
        bc = torch.from_numpy(rng9.standard_normal(Ac.shape[0]).astype(
            np.float32))
        grads = {}
        for where in ("cpu", dev):
            data = Ac.data.to(where, copy=True).requires_grad_()
            bb = bc.to(where, copy=True).requires_grad_()
            x, res = tpu_sparse_torch.solve(Ac.with_data(data), bb,
                                            method=method, tol=1e-6)
            before = counts()
            x.sum().backward()
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in counts().items()
                    if v != before[k]}
            check(res.converged, f"{method} forward on {where}")
            grads[where] = (data.grad.cpu(), bb.grad.cpu(), grew)
        gA, gb, grew = grads[dev]
        eA = rel_err(gA, grads["cpu"][0])
        eb = rel_err(gb, grads["cpu"][1])
        print(f"  {method}: backward launches on the card {grew}; grad rel "
              f"err card vs CPU: A {eA:.2e}, b {eb:.2e}")
        # float32 solves at tol 1e-6 by two loops (fused on the card, the
        # plain loop on the CPU) agree to ~1e-4 relative
        check(eA <= 5e-3 and eb <= 5e-3, f"{method} adjoint: card and CPU "
              "gradients disagree")
        carrier = ("dia_cg_spmv_dot" if method == "cg"
                   else "dia_bicgstab_q")
        check(grew.get(carrier, 0) > 0,
              f"{method} backward did not launch {carrier} on A^T")
    main_runs["phase (9)"] = counts()

    # ---- (10) K10 at the main-path shape, times, bounds --------------------
    phase("(10) K10 launches against their plain versions at the main-path "
          "shape; times (CUDA events) and bounds")
    op = cuda_spmv.ExtendedStencilOperator(A)
    bx = op.extend(b)
    st = cuda_bicgstab.FusedBiCGStabState(op, bx)
    st.run(torch.empty(3, dtype=torch.float32, device=dev))  # mid-solve
    pl_ = {k: v.clone() for k, v in dict(
        x=st.x, r=st.r, p0=st.p[st.cur], q0=st.q[st.cur], s=st.s, t=st.t,
        scal=st.scal, part=st.part).items()}
    zero = lambda: torch.zeros_like(bx)  # noqa: E731
    pk, qk, pp, qp = zero(), zero(), zero(), zero()
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    cuda_bicgstab.dia_bicgstab_q(op, st.r, st.p[st.cur], st.q[st.cur],
                                 st.rhat, pk, qk, st.scal, st.part)
    cuda_bicgstab.dia_bicgstab_q_plain(op, pl_["r"], pl_["p0"], pl_["q0"],
                                       st.rhat, pp, qp, pl_["scal"],
                                       pl_["part"])
    torch.cuda.synchronize()
    e_q = max(float((pk - pp).abs().max()), float((qk - qp).abs().max()))
    cuda_bicgstab.dia_bicgstab_t(op, st.r, qk, st.s, st.t, st.scal, st.part,
                                 st.counter)
    cuda_bicgstab.dia_bicgstab_t_plain(op, pl_["r"], qp, pl_["s"], pl_["t"],
                                       pl_["scal"], pl_["part"], cnt)
    torch.cuda.synchronize()
    e_t = max(float((st.s - pl_["s"]).abs().max()),
              float((st.t - pl_["t"]).abs().max()))
    e_scal_t = rel_err(st.scal, pl_["scal"])
    h_k = torch.zeros(1, dtype=torch.float32, device=dev)
    h_p = torch.zeros(1, dtype=torch.float32, device=dev)
    cuda_bicgstab.dia_bicgstab_update(op, st.x, st.r, pk, st.s, st.t,
                                      st.rhat, st.scal, st.part, st.counter,
                                      h_k)
    cuda_bicgstab.dia_bicgstab_update_plain(op, pl_["x"], pl_["r"], pp,
                                            pl_["s"], pl_["t"], st.rhat,
                                            pl_["scal"], pl_["part"], cnt,
                                            h_p)
    torch.cuda.synchronize()
    e_u = max(float((st.x - pl_["x"]).abs().max()),
              float((st.r - pl_["r"]).abs().max()))
    e_h = abs(float(h_k) - float(h_p)) / max(abs(float(h_p)), 1e-30)
    e_scal_u = rel_err(st.scal, pl_["scal"])
    print(f"  dia_bicgstab_q max abs err {e_q:.2e} (max|q| "
          f"{float(qp.abs().max()):.2e}); dia_bicgstab_t {e_t:.2e}, scalars "
          f"rel {e_scal_t:.1e}; dia_bicgstab_update {e_u:.2e}, ||r||^2 rel "
          f"{e_h:.1e}, scalars rel {e_scal_u:.1e}")
    # the kernels fuse multiply-adds and sum in double; 1e-5 of the
    # vectors' scale is a few float32 ulps
    scale = float(bx.abs().max())
    check(e_q <= 1e-5 * float(qp.abs().max()) and e_t <= 1e-5 * scale
          and e_u <= 1e-5 * scale and e_h <= 1e-5 and e_scal_t <= 1e-5
          and e_scal_u <= 1e-5,
          "K10 launches disagree with the plain versions")
    note("dia_bicgstab_q", max_abs_err=e_q,
         ms=cuda_time_ms(lambda: cuda_bicgstab.dia_bicgstab_q(
             op, st.r, st.p[st.cur], st.q[st.cur], st.rhat, pk, qk, st.scal,
             st.part)),
         plain_ms=cuda_time_ms(lambda: cuda_bicgstab.dia_bicgstab_q_plain(
             op, pl_["r"], pl_["p0"], pl_["q0"], st.rhat, pp, qp,
             pl_["scal"], pl_["part"])))
    note("dia_bicgstab_t", max_abs_err=e_t,
         ms=cuda_time_ms(lambda: cuda_bicgstab.dia_bicgstab_t(
             op, st.r, qk, st.s, st.t, st.scal, st.part, st.counter)),
         plain_ms=cuda_time_ms(lambda: cuda_bicgstab.dia_bicgstab_t_plain(
             op, pl_["r"], qp, pl_["s"], pl_["t"], pl_["scal"], pl_["part"],
             cnt)))
    note("dia_bicgstab_update", max_abs_err=e_u,
         ms=cuda_time_ms(lambda: cuda_bicgstab.dia_bicgstab_update(
             op, st.x, st.r, pk, st.s, st.t, st.rhat, st.scal, st.part,
             st.counter, h_k)),
         plain_ms=cuda_time_ms(
             lambda: cuda_bicgstab.dia_bicgstab_update_plain(
                 op, pl_["x"], pl_["r"], pp, pl_["s"], pl_["t"], st.rhat,
                 pl_["scal"], pl_["part"], cnt, h_p)))
    del st, pl_, pk, qk, pp, qp

    # library yardstick for kernel 1: one cuSPARSE CSR matvec of the same
    # matrix (torch.sparse_csr_tensor), timed here and used nowhere in the
    # port
    def csr_of(A_):
        offs = torch.tensor(A_.offsets, device=dev)
        order = torch.argsort(offs)
        cols = (torch.arange(A_.shape[0], device=dev)[:, None]
                + offs[order][None, :])
        mask = (cols >= 0) & (cols < A_.shape[1])
        crow = torch.zeros(A_.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(mask.sum(1), 0)
        return torch.sparse_csr_tensor(
            crow.to(torch.int32), cols[mask].to(torch.int32),
            A_.data[order].T[mask], size=A_.shape)

    for key, A_, label in (("f32", A_cg, f"poisson3d_27pt({MAIN_NX})"),
                           ("f64", A64_cg, f"poisson3d_27pt({F64_NX})")):
        Acsr = csr_of(A_)
        xv = torch.from_numpy(np.random.default_rng(SEED + 10).standard_normal(
            A_.shape[0])).to(dev, A_.data.dtype)
        e_lib = rel_err(torch.mv(Acsr, xv), ref.dia_spmv(A_, xv))
        lib_ms = cuda_time_ms(lambda: torch.mv(Acsr, xv))
        print(f"  cuSPARSE CSR matvec, {label} {key}: {lib_ms:.4f} ms "
              f"(rel err to the plain SpMV {e_lib:.1e})")
        check(e_lib <= 1e-5, "the CSR yardstick computes another function")
        note(f"dia_spmv_{key}", library_ms=lib_ms)
        note(f"dia_spmv_ext_{key}", library_ms=lib_ms)
        del Acsr

    # least time for each kernel's work: bytes over 3.35 TB/s, operations
    # over 67 TFLOP/s (float32) / 34 TFLOP/s (float64), the H100 SXM data
    # sheet at 700 W; each input read once and each output written once
    def bound(name, n_, ndiag, rows, flops_per_row, size):
        t_bytes = (ndiag + rows) * n_ * size / 3.35e12 * 1e3
        t_ops = (2 * ndiag + flops_per_row) * n_ / (
            67e12 if size == 4 else 34e12) * 1e3
        note(name, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")

    nd = len(A.offsets)
    n64 = A64_cg.shape[0]
    bound("dia_spmv_ext_f32", n, nd, 2, 0, 4)
    bound("dia_spmv_f64", n64, nd, 2, 0, 8)
    bound("dia_spmv_ext_f64", n64, nd, 2, 0, 8)
    bound("dia_cg_spmv_dot", n, nd, 4, 4, 4)
    bound("dia_cg_update", n, 0, 6, 6, 4)
    bound("dia_bicgstab_q", n, nd, 6, 6, 4)
    bound("dia_bicgstab_t", n, nd, 4, 8, 4)
    bound("dia_bicgstab_update", n, 0, 7, 10, 4)
    for k in ("dia_cg_spmv_dot", "dia_cg_update", "dia_bicgstab_q",
              "dia_bicgstab_t", "dia_bicgstab_update"):
        note(k, library_ms=None)   # no one PyTorch call computes these
    per_it = sum(results[k]["ms"] for k in
                 ("dia_bicgstab_q", "dia_bicgstab_t", "dia_bicgstab_update"))
    for k in ("dia_spmv_ext_f32", "dia_spmv_f64", "dia_spmv_ext_f64",
              "dia_cg_spmv_dot", "dia_cg_update", "dia_bicgstab_q",
              "dia_bicgstab_t", "dia_bicgstab_update"):
        v = results[k]
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        print(f"  {k:22s} kernel {v['ms']:.4f} ms  bound {v['bound_ms']:.4f}"
              f" ms ({v['bound_by']}, {v['bound_ms'] / v['ms']:.2f} of it)"
              f"  plain {v['plain_ms']:.4f} ms  library {lib}")
    print(f"  K10 iteration (three launches) {per_it:.4f} ms at n={n}")

    # ---- (11) nonsymmetric solve times -------------------------------------
    phase("(11) nonsymmetric solves: times (CUDA events, median and min-max "
          "of 5) beside the plain versions")
    rows = [
        ("bicgstab f32 (K10)", lambda: tpu_sparse_torch.solve(
            A, b, method="bicgstab", tol=1e-6, maxiter=500)[1].iterations,
         lambda: int(bicgstab_full(lambda v: ref.dia_spmv(A, v), b,
                                   tol=1e-6, maxiter=500)[2])),
        ("gmres(20) f32 (kernel 1)", lambda: tpu_sparse_torch.solve(
            A, b, method="gmres", restart=20, tol=1e-6,
            maxiter=500)[1].iterations,
         lambda: int(gmres_full(lambda v: ref.dia_spmv(A, v), b, tol=1e-6,
                                restart=20, maxiter=500)[2])),
    ]
    for method, full in (("bicgstab", bicgstab_full), ("gmres", gmres_full)):
        rows += [
            (f"{method} f64 full {F64_NX}^3", lambda m=method: (
                tpu_sparse_torch.solve(A64, b64, method=m, tol=1e-8,
                                       precision="full")[1].iterations),
             lambda f=full: int(f(lambda v: ref.dia_spmv(A64, v), b64,
                                  tol=1e-8)[2])),
            (f"{method} f64 auto {F64_NX}^3", lambda m=method: (
                tpu_sparse_torch.solve(A64, b64, method=m,
                                       tol=1e-8)[1].iterations), None)]
    for label, fn, plain in rows:
        ms = solve_ms(fn)
        pms = solve_ms(plain) if plain is not None else None
        its = fn()
        pits = plain() if plain is not None else None
        print(f"  solve {label:30s} {fmt(ms)} {its} it;   plain "
              + (f"{fmt(pms)} {pits} it" if pms is not None
                 else "not measured (no plain refinement loop)"),
              flush=True)

    # ---- (12)-(14) the general-structure path (CWELL, K4 / K5) ------------
    def times(fn, inner):
        ts = cuda_times_ms(fn, warmup=1 if inner == 1 else 2, reps=5,
                           inner=inner)
        return float(np.median(ts)), min(ts), max(ts)

    systems = general_structure_phases(
        dev, MAIN_NX, note=note, counts=counts, reset_counts=reset_counts,
        main_runs=main_runs, times=times, cg_dia_iters=solves[None],
        A_cg=A_cg, b_cg=b_cg, A_cd=A, b_cd=b)
    del A, b, A_cg, b_cg, A64, b64, A64_cg, op, bx
    torch.cuda.empty_cache()

    # ---- (15)-(18) the multi-RHS path (K6/K7, K8) ------------------------
    errs = spmm_kernel_phases(dev)
    multirhs_phases(dev, systems, note=note, counts=counts,
                    reset_counts=reset_counts, main_runs=main_runs,
                    times=times, results=results, edge_errs=errs)

    # ---- results -----------------------------------------------------------
    src_spmv = "tpu_sparse_torch/csrc/dia_spmv.cu"
    src_cg = "tpu_sparse_torch/csrc/dia_cg.cu"
    src_bicg = "tpu_sparse_torch/csrc/dia_bicgstab.cu"
    k10 = "tpu_sparse/kernels/pallas_bicgstab.py:52"
    origin = {
        "dia_spmv_ext_f32": (src_spmv,
                             "tpu_sparse/kernels/pallas_spmv.py:279"),
        "dia_spmv_f64": (src_spmv, "tpu_sparse/kernels/pallas_spmv.py:662"),
        "dia_spmv_ext_f64": (src_spmv,
                             "tpu_sparse/kernels/pallas_spmv.py:662"),
        "dia_cg_spmv_dot": (src_cg, "tpu_sparse/kernels/pallas_cg.py:51"),
        "dia_cg_update": (src_cg, "tpu_sparse/kernels/pallas_cg.py:51"),
        "dia_bicgstab_q": (src_bicg, k10),
        "dia_bicgstab_t": (src_bicg, k10),
        "dia_bicgstab_update": (src_bicg, k10),
        "cwell_spmv_f32": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:48"),
        "cwell_spmv_f64": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:307"),
        "cwell_spmm_f32": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:639"),
        "cwell_spmm_f64": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:505"),
        "bell_spmm_f32": ("tpu_sparse_torch/csrc/bell_spmm.cu",
                          "tpu_sparse/kernels/pallas_bell.py:34"),
        "bell_spmm_f64": ("tpu_sparse_torch/csrc/bell_spmm.cu",
                          "tpu_sparse/kernels/pallas_bell.py:34"),
    }
    launches = {k: sum(run[k] for run in main_runs.values() if k in run)
                for k in origin}
    print(f"  main-path launches by run: {main_runs}")
    for k in origin:
        check(launches[k] > 0, f"kernel {k} was not launched on the main "
              "path")
    kernels = []
    for name, (src, repl) in origin.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

def check_cwell_refusals(W, dev) -> None:
    """K4's wrapper raises on CPU operands, a non-contiguous x and mixed
    dtypes (a float32 pack W of width 200 on the card)."""
    import torch

    from tpu_sparse_torch.kernels import cuda_cwell

    x = torch.ones(200, device=dev)
    for bad_W, bad_x, exc in ((W, x.cpu(), ValueError),
                              (W.to("cpu"), x, ValueError),
                              (W, torch.ones(400, device=dev)[::2],
                               ValueError),
                              (W, x.double(), TypeError)):
        try:
            cuda_cwell.cwell_spmv_cuda(bad_W, bad_x)
        except exc:
            continue
        raise AssertionError("cwell_spmv_cuda took an operand it must "
                             "refuse")
    print("  cwell_spmv_cuda refuses CPU operands, a non-contiguous x and "
          "mixed dtypes")


def check_spmm_refusals(W, bell, dev) -> None:
    """The K6/K7 and K8 wrappers raise on a CPU operand, a dtype mismatch,
    a non-contiguous B and a B of the wrong shape (a float32 pack W of
    width 200 and a float32 BELL of width 64 on the card)."""
    import torch

    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell

    cases = []
    for fn, A_, m in ((cuda_cwell.cwell_spmm_cuda, W, 200),
                      (cuda_bell.bell_spmm_cuda, bell, 64)):
        B = torch.ones(m, 3, device=dev)
        cases += [(fn, A_, B.cpu(), ValueError),
                  (fn, A_.to("cpu"), B, ValueError),
                  (fn, A_, B.double(), TypeError),
                  (fn, A_, torch.ones(m, 6, device=dev)[:, ::2], ValueError),
                  (fn, A_, torch.ones(m + 1, 3, device=dev), ValueError),
                  (fn, A_, torch.ones(m, device=dev), ValueError)]
    big = bell.with_data(torch.ones(bell.n_block_rows, bell.ell_width, 72, 72,
                                    device=dev))
    big.shape = (bell.n_block_rows * 72, 72 * 8)
    cases.append((cuda_bell.bell_spmm_cuda, big,
                  torch.ones(72 * 8, 3, device=dev), ValueError))
    for fn, A_, B, exc in cases:
        try:
            fn(A_, B)
        except exc:
            continue
        raise AssertionError(f"{fn.__name__} took an operand it must refuse")
    print("  cwell_spmm_cuda and bell_spmm_cuda refuse CPU operands, mixed "
          "dtypes, a non-contiguous B, wrong shapes; bell_spmm_cuda bs > 64")


def spmm_kernel_phases(dev) -> dict:
    """Phases (15)-(16): K6/K7 and K8 against their plain versions on edge
    cases, float32 within 1e-5 and float64 within 1e-12 of max|Y|, reruns
    bit-identical, and the wrappers' refusals. Returns the largest abs
    error per kernel name."""
    import scipy.sparse as sp
    import torch

    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    rng = np.random.default_rng(SEED + 15)
    bound = {torch.float32: 1e-5, torch.float64: 1e-12}
    worst = {}

    def random_csr(n_, m_, per_row, dtype):
        rows = np.repeat(np.arange(n_), per_row)
        S = sp.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                           (rows, rng.integers(0, m_, rows.size))),
                          shape=(n_, m_))
        S.sort_indices()
        return conv.csr_from_arrays(S.data, S.indices, S.indptr, (n_, m_),
                                    device=dev)

    def check_spmm(label, kernel, plain, A_, B, name):
        Y0 = plain(A_, B)
        Y1 = kernel(A_, B)
        Y2 = kernel(A_, B)
        torch.cuda.synchronize()
        scale = float(Y0.abs().max()) if Y0.numel() else 0.0
        err = float((Y1 - Y0).abs().max()) if Y0.numel() else 0.0
        key = f"{name}_f{str(B.dtype)[-2:]}"
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= bound[B.dtype] * scale,
              f"{name} disagrees with the plain version on {label}: "
              f"{err} > {bound[B.dtype]} * {scale}")
        check(torch.equal(Y1, Y2), f"{name} rerun differs on {label}")
        return err, scale

    # ---- (15) K6/K7 ----------------------------------------------------
    phase("(15) K6/K7 (cwell_spmm) against the plain version on edge cases")
    ks = (1, 3, 8, 33, 128, 130)
    for label, n_, m_, per_row, groups in (
            ("random 3000x2500", 3000, 2500, 8, (1, 2, 4)),
            ("n, m not x128: 1001x777", 1001, 777, 7, (1,)),
            ("m < 256: 300x200", 300, 200, 5, (1, 2)),
            ("empty 300x300", 300, 300, 0, (1,))):
        for dt in (np.float32, np.float64):
            A_ = random_csr(n_, m_, per_row, dt)
            for Q in groups:
                W = csr_to_cwell(A_, group=Q)
                if label.startswith("m < 256"):
                    # padding slots (value 0) pointing at columns >= m
                    pad = (W.vals == 0) & (torch.arange(128, device=dev)
                                           % 3 == 0)
                    W.idx2[pad] = 250 - 128 * W.srow[:, :, None].expand_as(
                        W.idx2)[pad]
                    check(int((W.gcols() >= m_).sum()) > 0,
                          "no padding column past m")
                errs = []
                for k in ks:
                    B = torch.from_numpy(rng.standard_normal((m_, k)).astype(
                        dt)).to(dev)
                    errs.append(check_spmm(f"{label} Q={Q} k={k}",
                                           cuda_cwell.cwell_spmm_cuda,
                                           ref.cwell_spmm, W, B,
                                           "cwell_spmm")[0])
                print(f"  {label:26s} {str(np.dtype(dt)):7s} Q={Q} "
                      f"n_blocks*128={W.n_blocks * 128}: k={ks} max abs "
                      f"err {max(errs):.2e}")

    # ---- (16) K8 -------------------------------------------------------
    phase("(16) K8 (bell_spmm) against the plain version on edge cases")
    for nb, bs, density, pad in ((40, 8, 0.2, 0), (40, 8, 0.2, 5),
                                 (30, 3, 0.3, 2), (12, 16, 0.5, 0),
                                 (6, 64, 0.5, 1)):
        mask = rng.random((nb, nb)) < density
        np.fill_diagonal(mask, True)
        Ad = np.zeros((nb * bs, nb * bs))
        for i, j in zip(*np.nonzero(mask)):
            Ad[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = \
                rng.standard_normal((bs, bs))
        for dt in (torch.float32, torch.float64):
            S = csr_to_bsr(conv.dense_to_csr(torch.from_numpy(Ad).to(
                dev, dt)), bs)
            L = int(torch.diff(S.indptr.long()).max()) + pad
            bell = bsr_to_bell(S, ell_width=L)
            errs = []
            for k in (1, 5, 130, 300):
                B = torch.from_numpy(rng.standard_normal((nb * bs, k))).to(
                    dev, dt)
                errs.append(check_spmm(f"bs={bs} L={L} k={k}",
                                       cuda_bell.bell_spmm_cuda,
                                       ref.bell_spmm, bell, B,
                                       "bell_spmm")[0])
            print(f"  {nb} block rows, bs={bs}, L={L} ({pad} padding "
                  f"blocks), {str(dt)[6:]}: k=(1, 5, 130, 300) max abs err "
                  f"{max(errs):.2e}")
    W = csr_to_cwell(random_csr(300, 200, 5, np.float32))
    S = csr_to_bsr(conv.dense_to_csr(torch.eye(64, device=dev)), 8)
    check_spmm_refusals(W, bsr_to_bell(S), dev)
    return worst


def general_structure_phases(dev, nx, *, note, counts, reset_counts,
                             main_runs, times, cg_dia_iters, A_cg, b_cg,
                             A_cd, b_cd):
    """Phases (12)-(14): K4 / K5 on edge packs, the general-structure main
    path on the CWELL packs of the nx^3 systems, and their times.

    ``A_cg`` / ``b_cg``: the Poisson DIA system of phase (4), whose CG took
    ``cg_dia_iters`` iterations there; ``A_cd`` / ``b_cd``: the
    convection-diffusion DIA system of phase (8); ``times(fn, inner)``:
    (median, min, max) ms of 5 device-timed rounds."""
    import scipy.sparse as sp
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch.kernels import cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import CWELL, DIA, to_gpu_operator
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.cwell import coo_arrays_to_csr, csr_to_cwell

    bound = {torch.float32: 1e-5, torch.float64: 1e-13}
    norm = torch.linalg.vector_norm

    # ---- (12) K4 and K5 against their plain versions -----------------------
    phase("(12) K4 / K5 (cwell_spmv) against the plain version on edge "
          "packs; the card's packer against the CPU's")
    rng = np.random.default_rng(SEED)

    def random_csr(n_, m_, per_row, dtype, where=dev):
        """Up to per_row random entries a row (duplicates summed)."""
        rows = np.repeat(np.arange(n_), per_row)
        S = sp.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                           (rows, rng.integers(0, m_, rows.size))),
                          shape=(n_, m_))
        S.sort_indices()
        return conv.csr_from_arrays(S.data, S.indices, S.indptr, (n_, m_),
                                    device=where)

    def check_cwell(label, W, x):
        """K4/K5 against reference.cwell_spmv: max abs error <= bound *
        max|y| (exactly 0 where y is 0); a rerun gives the same bits."""
        y0 = ref.cwell_spmv(W, x)
        y1 = cuda_cwell.cwell_spmv_cuda(W, x)
        y2 = cuda_cwell.cwell_spmv_cuda(W, x)
        torch.cuda.synchronize()
        scale = float(y0.abs().max()) if y0.numel() else 0.0
        err = float((y1 - y0).abs().max()) if y0.numel() else 0.0
        name = str(x.dtype).replace("torch.", "")
        print(f"  {label:34s} {name} S={W.planes:<4d} fill {W.fill:.3f} "
              f"Q={W.group}: max abs err {err:.2e} (max|y| {scale:.2e})")
        check(err <= bound[x.dtype] * scale,
              f"K4/K5 disagree with the plain version on {label} {name}")
        check(torch.equal(y1, y2), f"K4/K5 rerun differs on {label} {name}")
        return err

    for label, n_, m_, k_ in (("random 6000x5000", 6000, 5000, 8),
                              ("rectangular 1000x3001", 1000, 3001, 6),
                              ("rectangular 3001x1000", 3001, 1000, 6),
                              ("m < 256: 300x200", 300, 200, 5),
                              ("n, m not x128: 1001x777", 1001, 777, 7),
                              ("empty 300x300", 300, 300, 0),
                              ("empty 5x5", 5, 5, 0)):
        for dt in (np.float32, np.float64):
            A_ = random_csr(n_, m_, k_, dt)
            x_ = torch.from_numpy(rng.standard_normal(m_).astype(dt)).to(dev)
            for Q in (1, 2, 4, 8) if label.startswith("random") else (1,):
                check_cwell(label, csr_to_cwell(A_, group=Q), x_)
    # the card's packer against the CPU's, byte for byte, at 32^3
    A32 = conv.to_csr(gen.poisson3d_27pt(32, device=dev))
    x32 = torch.from_numpy(rng.standard_normal(A32.shape[1]).astype(
        np.float32)).to(dev)
    for Q in (1, 4):
        Wg, Wc = csr_to_cwell(A32, group=Q), csr_to_cwell(A32.to("cpu"),
                                                           group=Q)
        same = all(torch.equal(getattr(Wg, k).cpu(), getattr(Wc, k))
                   for k in ("vals", "idx2", "srow"))
        print(f"  poisson3d_27pt(32) as CSR, Q={Q}: card pack == CPU pack: "
              f"{same} (S={Wg.planes}, fill {Wg.fill:.4f})")
        check(same and Wg.fill == Wc.fill, "the card's pack differs")
        check_cwell(f"poisson3d_27pt(32) CSR, Q={Q}", Wg, x32)
        check_cwell(f"poisson3d_27pt(32) CSR, Q={Q}",
                    Wg.with_data(Wg.vals.double()), x32.double())
    check_cwell_refusals(csr_to_cwell(random_csr(300, 200, 5, np.float32)),
                         dev)
    del A32, Wg, Wc

    # ---- (13) main path: general structure ---------------------------------
    phase(f"(13) main path: solve() on CWELL packs of the {nx}^3 systems "
          f"taken as general CSR")
    rng = np.random.default_rng(SEED)
    A_dia, b = A_cg, b_cg
    n = A_dia.shape[0]
    t0 = time.perf_counter()
    A = conv.to_csr(A_dia)
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    W = csr_to_cwell(A)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    print(f"  poisson3d_27pt({nx}) as CSR: n={n} nnz={A.nnz} (to_csr "
          f"{t_csr:.2f} s); CWELL pack on the card {t_pack * 1e3:.1f} ms "
          f"(wall): S={W.planes} fill {W.fill:.4f} slots {W.vals.numel()}")
    nz = A.data != 0
    A_nz = coo_arrays_to_csr(A.row_ids()[nz], A.indices[nz], A.data[nz],
                             A.shape)
    Wc = W.tocsr()
    check(all(torch.equal(getattr(Wc, k), getattr(A_nz, k))
              for k in ("data", "indices", "indptr")),
          "W.tocsr() differs from A")
    print(f"  W.tocsr() == A without its {A.nnz - A_nz.nnz} explicit zeros")
    del nz, A_nz, Wc
    op_d = to_gpu_operator(A)
    op_c = to_gpu_operator(A, max_diags=16)
    print(f"  to_gpu_operator(A) -> {op_d}; (A, max_diags=16) -> {op_c}")
    check(isinstance(op_d, DIA) and op_d.offsets == A_dia.offsets,
          "to_gpu_operator did not return the DIA matrix")
    check(isinstance(op_c, CWELL) and torch.equal(op_c.vals, W.vals),
          "to_gpu_operator(max_diags=16) did not return the CWELL pack")
    del op_d, op_c
    C = conv.to_csr(A_cd)
    WC = csr_to_cwell(C)
    print(f"  convection_diffusion_3d_27pt({nx}) as CSR: CWELL S="
          f"{WC.planes} fill {WC.fill:.4f}")
    A64_dia = gen.poisson3d_27pt(nx, dtype=np.float64, device=dev)
    A64 = conv.to_csr(A64_dia)
    W64 = csr_to_cwell(A64)
    x64_true = torch.from_numpy(rng.standard_normal(n)).to(dev)
    b64 = ref.dia_spmv(A64_dia, x64_true)
    del C
    torch.cuda.synchronize()

    reset_counts()  # the main-path run of this slice starts here

    def run(label, W_, b_, truth, tol, carriers, limit, **kw):
        before = counts()
        t0 = time.perf_counter()
        x, res = tpu_sparse_torch.solve(W_, b_, tol=tol, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        true_rel = float(norm(b_ - truth(x)) / norm(b_))
        print(f"  {label}: {res}; true rel res {true_rel:.2e}; first-call "
              f"wall {wall * 1e3:.1f} ms; launches {grew}")
        check(res.converged, f"{label} did not converge")
        check(true_rel <= limit, f"{label}: true residual {true_rel}")
        check(all(grew.get(k, 0) > 0 for k in carriers),
              f"{label}: {carriers} did not carry the solve")
        return res

    f32, f64 = ("cwell_spmv_f32",), ("cwell_spmv_f64",)
    res = run("cg f32 on CWELL", W, b, lambda v: ref.dia_spmv(A_dia, v),
              1e-6, f32, 1e-5, method="cg", maxiter=500)
    print(f"  cg on CWELL {res.iterations} iterations; on DIA (phase 4) "
          f"{cg_dia_iters}")
    for method, kw in (("bicgstab", {}), ("gmres", dict(restart=20))):
        run(f"{method} f32 on CWELL (convection-diffusion)", WC, b_cd,
            lambda v: ref.dia_spmv(A_cd, v), 1e-6, f32, 1e-5,
            method=method, maxiter=500, **kw)
    run("cg f64 full on CWELL", W64, b64,
        lambda v: ref.dia_spmv(A64_dia, v), 1e-8, f64, 1.01e-8,
        method="cg", precision="full")
    run("cg f64 auto on CWELL", W64, b64,
        lambda v: ref.dia_spmv(A64_dia, v), 1e-8, f32 + f64, 1.01e-8,
        method="cg", precision="auto")

    # the adjoint on a 32^3 CWELL, on the card against the CPU
    for method, make in (("cg", gen.poisson3d_27pt),
                         ("bicgstab", gen.convection_diffusion_3d_27pt)):
        Wcpu = csr_to_cwell(conv.to_csr(make(32, device="cpu")))
        bc = torch.from_numpy(rng.standard_normal(Wcpu.shape[0]).astype(
            np.float32))
        grads = {}
        for where in ("cpu", dev):
            W_ = Wcpu.to(where)
            vals = W_.vals.clone().requires_grad_()
            bb = bc.to(where, copy=True).requires_grad_()
            x, res = tpu_sparse_torch.solve(W_.with_data(vals), bb,
                                            method=method, tol=1e-6)
            before = counts()
            x.sum().backward()
            torch.cuda.synchronize()
            check(res.converged, f"{method} forward on {where}")
            grads[where] = (vals.grad.cpu(), bb.grad.cpu(),
                            {k: v - before[k] for k, v in counts().items()
                             if v != before[k]})
        gA, gb, grew = grads[dev]
        eA, eb = rel_err(gA, grads["cpu"][0]), rel_err(gb, grads["cpu"][1])
        print(f"  adjoint {method} on a 32^3 CWELL: backward launches on "
              f"the card {grew}; grad rel err card vs CPU: vals {eA:.2e}, "
              f"b {eb:.2e}")
        check(eA <= 5e-3 and eb <= 5e-3,
              f"{method} adjoint on CWELL: card and CPU disagree")
        check(grew.get("cwell_spmv_f32", 0) > 0,
              f"{method} backward did not run K4")

    # reorder="rcm" on a renumbered 32^3 system (solved as CSR, as in JAX)
    P = conv.to_scipy_csr(gen.poisson3d_27pt(32, device="cpu"))
    perm = rng.permutation(P.shape[0])
    Ps = P[perm][:, perm].tocsr()
    Ps.sort_indices()
    As = conv.csr_from_arrays(Ps.data, Ps.indices, Ps.indptr, Ps.shape,
                              device=dev)
    xs_true = torch.from_numpy(rng.standard_normal(Ps.shape[0]).astype(
        np.float32)).to(dev)
    bs = ref.csr_spmv(As, xs_true)
    natural = conv.csr_from_arrays(P.data, P.indices, P.indptr, P.shape,
                                   device=dev)
    print(f"  renumbered 32^3: CWELL fill {csr_to_cwell(As).fill:.4f} "
          f"(natural order {csr_to_cwell(natural).fill:.4f})")
    run("cg f32 reorder='rcm' (renumbered 32^3)", As, bs,
        lambda v: ref.csr_spmv(As, v), 1e-6, (), 1e-5, method="cg",
        reorder="rcm")
    main_runs["phase (13)"] = counts()
    print(f"  launches in the main-path run (phase 13): "
          f"{main_runs['phase (13)']}")
    for k in f32 + f64:
        check(main_runs["phase (13)"][k] > 0,
              f"kernel {k} was not launched on the main path")

    # ---- (14) times --------------------------------------------------------
    phase("(14) times (CUDA events, median and min-max of 5): K4 / K5 at "
          f"the {nx}^3 packs beside bounds and cuSPARSE; CWELL solves "
          "beside the DIA solves")

    def fmt(t):
        return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"

    for key, W_, Ac in (("cwell_spmv_f32", W, A),
                        ("cwell_spmv_f64", W64, A64)):
        dt = W_.vals.dtype
        xk = torch.from_numpy(np.random.default_rng(SEED + 14)
                              .standard_normal(n)).to(dev, dt)
        err = check_cwell(f"poisson3d_27pt({nx}) pack", W_, xk)
        t_k = times(lambda: cuda_cwell.cwell_spmv_cuda(W_, xk), 10)
        t_p = times(lambda: ref.cwell_spmv(W_, xk), 2)
        lib = torch.sparse_csr_tensor(Ac.indptr, Ac.indices, Ac.data,
                                      size=Ac.shape)
        e_lib = rel_err(torch.mv(lib, xk), ref.cwell_spmv(W_, xk))
        check(e_lib <= (1e-5 if dt == torch.float32 else 1e-12),
              "the CSR yardstick computes another function")
        t_l = times(lambda: torch.mv(lib, xk), 10)
        size = W_.vals.element_size()
        nb, S = W_.srow.shape
        nbytes = (W_.vals.numel() * (size + 4) + nb * S * 4
                  + (W_.shape[0] + W_.shape[1]) * size)
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = 2 * W_.nnz / (67e12 if size == 4 else 34e12) * 1e3
        note(key, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
             library_ms=t_l[0], bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"  {key}: kernel {fmt(t_k)}; bound {max(t_bytes, t_ops):.4f}"
              f" ms ({nbytes / 1e6:.1f} MB, {max(t_bytes, t_ops) / t_k[0]:.2f}"
              f" of it); plain {fmt(t_p)}; cuSPARSE CSR matvec {fmt(t_l)} "
              f"(rel err {e_lib:.1e}); kernel / cuSPARSE "
              f"{t_k[0] / t_l[0]:.2f}; {W_.nnz / (t_k[0] * 1e-3) / 1e9:.2f} "
              f"Gnnz/s", flush=True)
        del lib

    def its(fn):
        return lambda: fn()[1].iterations

    solve = tpu_sparse_torch.solve
    rows = [
        ("cg f32", its(lambda: solve(W, b, tol=1e-6, maxiter=500)),
         its(lambda: solve(A_dia, b, tol=1e-6, maxiter=500))),
        ("bicgstab f32", its(lambda: solve(WC, b_cd, method="bicgstab",
                                           tol=1e-6, maxiter=500)),
         its(lambda: solve(A_cd, b_cd, method="bicgstab", tol=1e-6,
                           maxiter=500))),
        ("gmres(20) f32", its(lambda: solve(WC, b_cd, method="gmres",
                                            restart=20, tol=1e-6,
                                            maxiter=500)),
         its(lambda: solve(A_cd, b_cd, method="gmres", restart=20,
                           tol=1e-6, maxiter=500))),
        ("cg f64 full", its(lambda: solve(W64, b64, tol=1e-8,
                                          precision="full")),
         its(lambda: solve(A64_dia, b64, tol=1e-8, precision="full"))),
        ("cg f64 auto", its(lambda: solve(W64, b64, tol=1e-8)),
         its(lambda: solve(A64_dia, b64, tol=1e-8))),
    ]
    for label, on_cwell, on_dia in rows:
        t_c, t_d = times(on_cwell, 1), times(on_dia, 1)
        print(f"  solve {label:14s} CWELL {fmt(t_c)} {on_cwell()} it;   DIA "
              f"{fmt(t_d)} {on_dia()} it", flush=True)
    return dict(A=A, W=W, WC=WC, W64=W64, A_dia=A_dia, A_cd=A_cd,
                A64_dia=A64_dia)


def kron_bell(dev, nx, rng, bs=8):
    """kron(poisson3d_27pt(nx), C) as a BELL through
    ``bsr_to_bell(csr_to_bsr(CSR, bs))``, built on the card: the shape of a
    PDE with bs coupled unknowns per grid node. C = Q diag(1 + u) Q^T is
    SPD with eigenvalues in [1, 2) from the seed. Returns (BELL, CSR, the
    smallest eigenvalue of C)."""
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


def multirhs_phases(dev, g, *, note, counts, reset_counts, main_runs,
                    times, results, edge_errs, bell_nx=40):
    """Phases (17)-(18): the multi-RHS main path (K6/K7 on the 160^3 CWELL
    packs, K8 on a block-structured BELL) through ``solve(A, B)``, each
    column against the single-RHS solve of that column; then K6/K7 and K8
    times beside their bounds, plain versions, cuSPARSE SpMM and k x K4,
    and the multi-RHS solves beside k single-RHS solves. ``g``: the
    systems of phases (13)-(14)."""
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.solvers.batched import cols_norm

    solve = tpu_sparse_torch.solve
    W, WC, W64 = g["W"], g["WC"], g["W64"]
    n, K = W.shape[0], 8
    rng = np.random.default_rng(SEED)

    # ---- (17) main path ------------------------------------------------
    phase(f"(17) main path: solve(A, B) with B of {K} columns on the "
          "160^3 CWELL packs and on a block-structured BELL")
    B = torch.from_numpy(rng.standard_normal((n, K)).astype(np.float32)).to(
        dev)
    B64 = torch.from_numpy(rng.standard_normal((n, 4))).to(dev)
    t0 = time.perf_counter()
    bell, bell_csr, lmin = kron_bell(dev, bell_nx, rng)
    torch.cuda.synchronize()
    print(f"  kron(poisson3d_27pt({bell_nx}), C8): n={bell.shape[0]}, "
          f"{bell.n_block_rows} block rows, L={bell.ell_width}, "
          f"{bell.n_block_rows * bell.ell_width} stored 8x8 blocks "
          f"({bell.blocks.numel() * 4 / 1e6:.1f} MB f32), CSR nnz "
          f"{bell_csr.nnz}; smallest eigenvalue of C {lmin:.4f}; built on "
          f"the card in {time.perf_counter() - t0:.2f} s (wall)")
    check(lmin > 0.5, "the coupling block is not SPD")
    bell64 = bell.with_data(bell.blocks.double())
    Bb = torch.from_numpy(rng.standard_normal((bell.shape[0], K)).astype(
        np.float32)).to(dev)
    Bb64 = Bb[:, :4].double()
    truth = {id(W): lambda X: ref.dia_spmm(g["A_dia"], X),
             id(WC): lambda X: ref.dia_spmm(g["A_cd"], X),
             id(W64): lambda X: ref.dia_spmm(g["A64_dia"], X),
             id(bell): lambda X: ref.bell_spmm(bell, X),
             id(bell64): lambda X: ref.bell_spmm(bell64, X)}
    # (label, operand, B, kw, carriers, x agreement bound, iteration gap):
    # float32 batched solves run the single-RHS recurrence, but K6/K7 and
    # K8 sum each row in another order than K4, so a column crosses tol
    # some iterations apart (BiCGStab's residual is not monotone) and its
    # x differs at the level of the solve's error; block CG is another
    # algorithm, so only its x is held to the singles, at kappa * tol of
    # the 160^3 system (~1e-2); the float64 refinements at 1e-4 (kappa *
    # 1e-8)
    runs = [
        ("cg batched f32", W, B, dict(method="cg", tol=1e-6, maxiter=500),
         ("cwell_spmm_f32",), 1e-3, 5),
        ("cg block (M='jacobi') f32", W, B,
         dict(method="cg", M="jacobi", tol=1e-6, maxiter=500),
         ("cwell_spmm_f32",), 1e-2, None),
        ("bicgstab batched f32", WC, B,
         dict(method="bicgstab", tol=1e-6, maxiter=500),
         ("cwell_spmm_f32",), 1e-3, "bicgstab"),
        ("gmres(20) batched f32", WC, B,
         dict(method="gmres", restart=20, tol=1e-6, maxiter=500),
         ("cwell_spmm_f32",), 1e-3, 1),
        ("cg f64 auto (batched refinement, k=4)", W64, B64,
         dict(method="cg", tol=1e-8), ("cwell_spmm_f32", "cwell_spmm_f64"),
         1e-4, None),
        ("cg batched f32 on BELL", bell, Bb,
         dict(method="cg", tol=1e-6, maxiter=500), ("bell_spmm_f32",), 1e-3,
         5),
        ("cg f64 auto on BELL (k=4)", bell64, Bb64,
         dict(method="cg", tol=1e-8), ("bell_spmm_f32", "bell_spmm_f64"),
         1e-4, None),
    ]
    reset_counts()  # the main-path run of this slice starts here
    for label, op, Bm, kw, carriers, xbound, gap in runs:
        before = counts()
        t0 = time.perf_counter()
        X, res = solve(op, Bm, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        rel = cols_norm(Bm - truth[id(op)](X)) / cols_norm(Bm)
        print(f"  {label}: {res}; true rel res per column max "
              f"{float(rel.max()):.2e}; first-call wall {wall * 1e3:.1f} ms;"
              f" launches {grew}")
        check(res.converged, f"{label} did not converge")
        check(float(rel.max()) <= 10 * kw["tol"],
              f"{label}: true residual {float(rel.max())}")
        check(all(grew.get(k, 0) > 0 for k in carriers),
              f"{label}: {carriers} did not carry the solve")
        # each column against the single-RHS solve of that column
        diffs, its = [], []
        for j in range(Bm.shape[1]):
            xj, rj = solve(op, Bm[:, j].contiguous(), **kw)
            check(rj.converged, f"{label}: single column {j}")
            diffs.append(float(torch.linalg.vector_norm(X[:, j] - xj)
                               / torch.linalg.vector_norm(xj)))
            its.append(rj.iterations)
        if gap == "bicgstab":
            gap = max(5, max(its) // 5)
        print(f"    single-RHS solves of the columns: iterations {its} "
              f"(multi-RHS max {res.iterations}); rel x difference max "
              f"{max(diffs):.2e}")
        check(max(diffs) <= xbound,
              f"{label}: columns disagree with the single-RHS solves")
        if gap is not None:
            check(abs(res.iterations - max(its)) <= gap,
                  f"{label}: iterations {res.iterations} against {its}")
    # the single-RHS BELL solve runs K4 on the cached CWELL repack
    before = counts()
    x, res = solve(bell, Bb[:, 0].contiguous(), tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    print(f"  single-RHS solve(bell, b): {res}; launches {grew}")
    check(res.converged and grew.get("cwell_spmv_f32", 0) > 0
          and not grew.get("bell_spmm_f32"),
          "the single-RHS BELL solve did not run K4 on the repack")
    main_runs["phase (17)"] = counts()
    print(f"  launches in the main-path run (phase 17): "
          f"{main_runs['phase (17)']}")
    for k in ("cwell_spmm_f32", "cwell_spmm_f64", "bell_spmm_f32",
              "bell_spmm_f64"):
        check(main_runs["phase (17)"][k] > 0,
              f"kernel {k} was not launched on the main path")

    # ---- (18) times ----------------------------------------------------
    phase("(18) times (CUDA events, median and min-max of 5): K6/K7 and K8 "
          "beside bounds, plain versions, cuSPARSE SpMM and k x K4; "
          "multi-RHS solves beside k single-RHS solves")

    def fmt(t):
        return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"

    def spmm_row(key, kernel, plain, A_, csr, k, nbytes, flops, ktag):
        dt = A_.vals.dtype if hasattr(A_, "vals") else A_.blocks.dtype
        Bk = torch.from_numpy(np.random.default_rng(SEED + 18)
                              .standard_normal((A_.shape[1], k))).to(dev, dt)
        Y0, Y1 = plain(A_, Bk), kernel(A_, Bk)
        err = float((Y1 - Y0).abs().max())
        scale = float(Y0.abs().max())
        check(err <= (1e-5 if dt == torch.float32 else 1e-12) * scale,
              f"{key} disagrees with the plain version at k={k}")
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                      csr.data.to(dt), size=csr.shape)
        e_lib = rel_err(torch.sparse.mm(lib, Bk), Y0)
        check(e_lib <= (1e-5 if dt == torch.float32 else 1e-12),
              "the cuSPARSE yardstick computes another function")
        t_k = times(lambda: kernel(A_, Bk), 5)
        t_p = times(lambda: plain(A_, Bk), 1)
        t_l = times(lambda: torch.sparse.mm(lib, Bk), 5)
        size = torch.finfo(dt).bits // 8
        t_bytes = nbytes(size, k) / 3.35e12 * 1e3
        t_ops = flops * k / (67e12 if size == 4 else 34e12) * 1e3
        bound_ms = max(t_bytes, t_ops)
        k4 = results.get(f"cwell_spmv_f{size * 8}", {}).get("ms")
        k4s = "" if k4 is None else f"; {k} x K4 {k * k4:.4f} ms"
        print(f"  {key} k={k:3d}: kernel {fmt(t_k)}; bound {bound_ms:.4f} "
              f"ms ({nbytes(size, k) / 1e6:.1f} MB, {bound_ms / t_k[0]:.2f} "
              f"of it); plain {fmt(t_p)}; cuSPARSE SpMM {fmt(t_l)} (kernel /"
              f" cuSPARSE {t_k[0] / t_l[0]:.2f}){k4s}; max abs err "
              f"{err:.2e} (max|Y| {scale:.2e})", flush=True)
        if ktag:
            note(key, max_abs_err=max(err, edge_errs.get(key, 0.0)),
                 ms=t_k[0], plain_ms=t_p[0], library_ms=t_l[0],
                 bound_ms=bound_ms,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        del lib

    def cwell_bytes(W_):
        nb, S = W_.srow.shape
        return lambda size, k: (W_.vals.numel() * (size + 4) + nb * S * 4
                                + (W_.shape[0] + W_.shape[1]) * k * size)

    def bell_bytes(A_):
        return lambda size, k: (A_.blocks.numel() * size
                                + A_.indices.numel() * 4
                                + (A_.shape[0] + A_.shape[1]) * k * size)

    for k in (8, 32, 128):
        spmm_row("cwell_spmm_f32", cuda_cwell.cwell_spmm_cuda, ref.cwell_spmm,
                 W, g["A"], k, cwell_bytes(W), 2 * W.nnz, k == 8)
    from tpu_sparse_torch.sparse import convert as conv

    A64 = conv.to_csr(g["A64_dia"])
    spmm_row("cwell_spmm_f64", cuda_cwell.cwell_spmm_cuda, ref.cwell_spmm,
             W64, A64, 4, cwell_bytes(W64), 2 * W64.nnz, True)
    del A64
    for k in (8, 32):
        spmm_row("bell_spmm_f32", cuda_bell.bell_spmm_cuda, ref.bell_spmm,
                 bell, bell_csr, k, bell_bytes(bell), 2 * bell.blocks.numel(),
                 k == 8)
    spmm_row("bell_spmm_f64", cuda_bell.bell_spmm_cuda, ref.bell_spmm,
             bell64, bell_csr, 4, bell_bytes(bell64),
             2 * bell64.blocks.numel(), True)

    def multi_and_singles(op, Bm, kw):
        def multi():
            return solve(op, Bm, **kw)[1].iterations

        def singles():
            return [solve(op, Bm[:, j].contiguous(), **kw)[1].iterations
                    for j in range(Bm.shape[1])]
        return multi, singles

    for label, op, Bm, kw, *_ in runs:
        multi, singles = multi_and_singles(op, Bm, kw)
        t_m, t_s = times(multi, 1), times(singles, 1)
        print(f"  solve {label:38s} {fmt(t_m)} ({multi()} it);   "
              f"{Bm.shape[1]} single-RHS solves {fmt(t_s)} ({singles()} it);"
              f" ratio {t_s[0] / t_m[0]:.2f}", flush=True)

if __name__ == "__main__":
    sys.exit(main())
