"""Smoke run of the tpu_sparse_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of tpu_sparse_torch/csrc (nvcc, sm_90a, one nvcc per
source), checks each kernel against its plain PyTorch version, and drives
``tpu_sparse_torch.solve`` along its main paths, each with the launch
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
  residuals), the adjoint on a CWELL, and ``reorder="rcm"``; each solve
  builds at most one row-compact plan (the layout K4/K5 stream) and
  gathers its values once per values tensor. Phase (12) checks K4/K5 on
  edge packs (grouped, carried as numpy, more than 256 planes) against
  their plain version and the plane reference, and the card's packer
  against the CPU's; phase (14) times the plan's build, K4/K5 beside the
  bound of the plan's bytes and cuSPARSE, and the CWELL solves beside the
  DIA ones;
* phase (17): the multi-RHS path, ``solve(A, B)`` with B of 8 columns on
  the same 160^3 CWELL packs (batched CG, block CG with Jacobi, batched
  BiCGStab and GMRES(20): every matvec one K6/K7 launch; f64 'auto' at 4
  columns: K6/K7 in float and double) and on a block-structured BELL,
  kron(poisson3d_27pt(40), C8) with 110.6M stored entries (K8; its
  single-RHS solve runs K4 on the cached CWELL repack), each column held
  against the single-RHS solve of that column, the batched CG iterations
  against the recorded ones. K6/K7 streams the row-compact plan K4/K5
  use. Phases (15)-(16) check K6/K7 (against its plain version on the
  plan, every column against K4/K5 bit for bit: grouped, wide and
  segmented packs, empty rows and columns) and K8 (bs 1 to 64, padding
  blocks) on edge cases; phase (18) times them beside their bounds (K6/K7:
  the plan's bytes, the plane pack's printed beside), a cuSPARSE SpMM and
  k K4 launches, and the multi-RHS solves beside k single-RHS solves
  (median and min-max of 3).
* phase (20): the AMG and preconditioner path at n = 160^3: ``solve(A, b,
  backend="amg")`` (AMG-preconditioned CG; the V-cycle runs kernel 1 on
  the DIA levels and K4 on the CWELL restriction and prolongator), the
  stationary V-cycle iteration, ``M="amg" | "chebyshev" | "neumann"``, the
  AMG solve on the CWELL pack and with B of 8 columns (every level one
  K6/K7 SpMM), and at 64^3 ``M="fsai"`` and float64 ``M="amg"`` with
  ``precision="auto"`` (the cast hierarchy in the f32 sweeps, the fp64
  kernel in the outer residuals). Phase (19) builds the 160^3 hierarchy
  (native host set-up), prints its levels, holds its V-cycle against the
  same cycle on the plain versions and the block V-cycle against the
  single ones, and times the cycle by level; phase (21) runs the
  lid-driven cavity (``tpu_sparse_torch.apps.ldc``, float64: K3) on the
  card against the CPU at nx = 64 (20 steps) and at nx = 256 for 50
  steps;
* phases (22)-(23): single-reduction CG, FCG (M None and the AMG V(0,3)
  cycle), MINRES on the shifted, indefinite Poisson system and FGMRES(20)
  (M None and V(0,3)) through ``solve()`` on the 160^3 DIA systems
  (kernel 1) and CWELL packs (K4), f64 ``"auto"`` at 64^3, each beside
  its yardstick (the fused CG, AMG-PCG, GMRES(20)); their batched forms
  with B of 8 columns on the CWELL packs (every matvec one K6/K7 launch,
  every column against its single-RHS solve); the adjoint of the four
  methods at 32^3 on the card against the CPU; gradients through
  matrix-free callables (K4 with ``A_transpose``, a torch-op stencil
  closing over a coefficient, and the error a callable without a
  transpose raises);
* phases (24)-(25): the direct solvers through ``solve(...,
  method="direct")``: a tridiagonal n = 500 (PCR) against the CPU's
  Thomas solve, a dense n = 2,048, the general system poisson2d(256) +
  0.1 triu as CSR (n = 65,536: the supernodal LU, every level group one
  K4 / K5 launch, one K6/K7 launch with B of 8 columns) in float32 and
  float64 beside SuperLU's own solve of the same factors, the same system
  at n = 16,384 (and SparseLU there), the level solve against its plain
  version, level packs against the plain compact SpMV / SpMM, gradients
  on the card against the CPU; then the lid-driven cavity with
  ``solver="direct"`` (block PCR) against the CPU at nx = 64 (50 steps)
  and its
  steps per second at nx = 256;
* phase (26): ``tpu_sparse_torch.dist`` on an NCCL group of one rank
  (initialised in-process on a free localhost port): the halo CG on the
  cg_110M system and b (kernel 1 extended mode on the rank's rows, with
  and without Jacobi), the same CG on its CWELL pack (K4), float64 at
  64^3 on the DIA and CWELL routes (extended fp64 kernel 1, K5), block CG
  with B of 8 columns on the CWELL pack (K6/K7) and AMG-PCG with the
  row-sharded hierarchy at 64^3, each held against the single-device
  solve; the halo SpMV against kernel 1 and the CWELL routes against
  each other; times beside the single-device and fused CG; the
  collectives per iteration. No bytes cross a link on one rank: the
  scaling across cards is ``python -m tpu_sparse_torch.dist.scaling_probe``;
* phase (27): ILU(0) through ``solve(M="ilu0")``: the 160^3 set-up (the
  host factor and the level packs, timed apart; 1,114 levels each way),
  CG on the cg_110M system and b (every level sweep one K4 launch),
  BiCGStab on the convection-diffusion system, float64 'auto' and 'full'
  (K4 inner sweeps, K5 sweeps) and batched CG with B of 8
  columns (K6/K7 sweeps) at 64^3, and a CG gradient in b at 32^3 against
  the CPU;
  K4, K5 and K6/K7 against the plain compact product on those level
  packs (the deepest and every 32nd); the card's factor and applies against the CPU's at 16^3; one apply's
  time, launches and K4 device time; ILU-PCG beside M None / Jacobi; a
  cuSPARSE float64 CSR matvec at 160^3 (kernel 3's library yardstick);
* phase (28): native complex. CG (M None, Jacobi), BiCGStab and GMRES(20)
  on D^H A D of the 160^3 systems in complex64 (D = diag(exp(i theta)), a
  unitary similarity: the real solves' iterations), GMRES(20) on (1 +
  0.2i) C, CG and batched CG (B of 8 columns) on the CWELL of D^H A D,
  batched CG on the kron BELL made Hermitian in complex64 and complex128,
  complex128 'full' / 'mixed' / ILU(0) / batched at 64^3, a gradient at
  32^3 against the CPU, the supernodal LU of a complex general CSR at n =
  16,384 against SuperLU's own complex128 solve, and a real L with a
  complex b (one cast of L); then the complex64 / complex128 builds of
  kernel 1, K4 / K5, K6/K7 and K8 against their plain versions at the
  160^3 shapes, timed beside their bounds and cuSPARSE's complex CSR
  calls, and the complex solves beside the real ones;
* phase (29): bf16. CG (M None, Jacobi) on the bf16 copy of the 160^3
  Poisson matrix (bf16-exact values) with cg_110M's float32 b, held to
  the float32 plain extended loop (equal iterations, x within 1e-6);
  BiCGStab and GMRES(20) on the bf16 convection-diffusion system; cg_sr;
  CG on the bf16 CWELL; bf16 right-hand sides at tol 2e-2; batched CG
  with B of 8 columns on the bf16 CWELL and kron BELL; refined_solve with
  bf16 inner sweeps to 1e-8 in float64; a gradient in b; no values cast;
  then every bf16 build of kernel 1 (both modes), K4, K6/K7 and K8
  against its plain version at the 160^3 shapes, timed beside its bound,
  its plain version and torch's bf16 CSR call where torch takes the pair.
* phase (30): the tooling and the rest of the public API
  (``tooling_phases``). The benchmark harness at the north star's width
  (``poisson3d_27pt(160)`` in float64, as the JAX harness builds it: CG
  on the krylov backend, K3; AMG-PCG, K4 / K5 on its levels) with its
  markdown report and CSV, the report naming the card and its power
  limit; ``run.main(["--benchmark", "--quick"])``; the Poisson demo at
  nx = 160 (the fused CG, kernels 2-3); the inverse conductivity demo on
  the card (float64, K3) against the same run on the CPU; checkpoints of
  phase (4)'s x and an LDC state loaded back onto the card bit for bit;
  ``per_iter_time`` of kernel 1's float32 plain mode beside phase (6)'s
  device time; ``trace()`` of one fused CG solve, its Chrome trace
  holding the ``dia_cg`` kernels.

Phase (2) holds kernel 1's plain mode to its first design (v1,
``csrc/dia_spmv_v1.cuh``) bit for bit on its cases, as phases (6), (28)
and (29) do on the main-path, complex and bf16 operands; phase (6) times
v1 and the shipped plain mode in turns in every build at the 160^3 shapes
(f64 also at 64^3 and at the LDC's 256^2 5-point shape).

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
# which these solves do not call (phases (2), (4) and (6) check it apart);
# the preconditioned and AMG solves of phase (20) launch it.
MAIN_PATH_KERNELS = ("dia_spmv_ext_f32", "dia_spmv_f64", "dia_spmv_ext_f64",
                     "dia_cg_spmv_dot", "dia_cg_update")

# Iterations (GMRES: restart cycles) of phase (13)'s solves at MAIN_NX with
# the plane-walking K4 / K5, which summed each row's nonzeros in the order
# the compact kernel sums them (NVIDIA H100 80GB HBM3, 700 W).
# Iterations of phase (17)'s batched CG solves with the first designs of
# K6/K7 and K8, which summed each row in the order the current kernels sum
# it (NVIDIA H100 80GB HBM3, 700 W).
MULTI_RHS_ITERS = {"cg batched f32": 246, "cg batched f32 on BELL": 112}

PLANE_KERNEL_ITERS = {
    "cg f32 on CWELL": 106,
    "bicgstab f32 on CWELL (convection-diffusion)": 58,
    "gmres f32 on CWELL (convection-diffusion)": 5,
    "cg f64 full on CWELL": 224,
    "cg f64 auto on CWELL": 306,
}


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title}   [{time.perf_counter() - _START:.0f} s]",
          flush=True)


def rel_err(y, y0) -> float:
    return float((y - y0).abs().max() / y0.abs().max().clamp_min(1e-300))


def same_bits(a, b) -> bool:
    """a and b hold the same bits (NaNs compare by their bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def kernel1_turns(cases, times) -> None:
    """Kernel 1's plain mode: the first design (v1) and the shipped one, bit
    for bit, then timed in turns (v1, shipped, shipped, v1; each visit
    ``times(fn)``, a list of ms) on each (label, A, x), beside the bound
    (data, x and y bytes over 3.35 TB/s). These launches are comparisons,
    not main-path runs."""
    from tpu_sparse_torch.kernels import cuda_spmv

    for label, A, x in cases:
        y = cuda_spmv.dia_spmv_cuda(A, x)
        y1 = cuda_spmv.dia_spmv_v1_cuda(A, x)
        check(same_bits(y, y1),
              f"kernel 1 ({label}) differs from v1 in some bit")
        del y, y1
        calls = {"v1": lambda A=A, x=x: cuda_spmv.dia_spmv_v1_cuda(A, x),
                 "shipped": lambda A=A, x=x: cuda_spmv.dia_spmv_cuda(A, x)}
        t = {"v1": [], "shipped": []}
        for name in ("v1", "shipped", "shipped", "v1"):
            t[name] += times(calls[name])
        n, m = A.shape
        nbytes = (A.data.element_size() * len(A.offsets) * n
                  + x.element_size() * (n + m))
        bound = nbytes / 3.35e12 * 1e3
        med = {k: float(np.median(v)) for k, v in t.items()}
        print(f"  {label:40s} v1 {med['v1']:.4f} ms ({bound / med['v1']:.2f}"
              f" of bound; {min(t['v1']):.4f}-{max(t['v1']):.4f}), shipped "
              f"{med['shipped']:.4f} ms ({bound / med['shipped']:.2f}; "
              f"{min(t['shipped']):.4f}-{max(t['shipped']):.4f}), "
              f"{med['shipped'] / med['v1']:.3f} of v1; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB); == v1 bit for bit", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    import tpu_sparse_torch
    from tpu_sparse_torch import tracing
    from tpu_sparse_torch.kernels import (_build, cuda_bell, cuda_bicgstab,
                                          cuda_cg, cuda_cwell, cuda_spmv)
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner,
                                                 jacobi_preconditioner)
    from tpu_sparse_torch.solvers import bicgstab_full, cg_full, gmres_full
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.utils.timing import (cuda_flushed_times_ms,
                                               cuda_time_ms, cuda_times_ms)

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
          f"from {_build.CSRC_DIR.name}/")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  " + line.strip())

    # ---- (2) kernel 1 against its plain version ----------------------------
    phase("(2) kernel 1 (dia_spmv) against the plain version")
    bound = {torch.float32: 1e-5, torch.float64: 1e-13}

    def check_kernel1(label, A, x):
        """Kernel 1 in plain and extended mode against ``reference.dia_spmv``:
        max abs error <= bound * max|y|, extended margins exactly 0; the
        plain mode equal to the first design (v1) bit for bit.
        Returns (extended operator, extended x, abs err plain, abs err ext).
        """
        y0 = ref.dia_spmv(A, x)
        y1 = cuda_spmv.dia_spmv_cuda(A, x)
        v1_same = same_bits(y1, cuda_spmv.dia_spmv_v1_cuda(A, x))
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
              f"{e_ext / max(scale, 1e-300):.2e}, margins {margin}; plain "
              f"== v1 bit for bit: {v1_same}")
        check(v1_same, f"kernel 1 differs from v1 on {label} {name}")
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
    tracing.reset()
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
    x_cg = x  # phase (4)'s solution, checkpointed in phase (30)

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

    # kernel 1's plain mode, v1 and the shipped design in turns, every
    # build at the main-path shapes and f64 at the LDC's (256^2, 5-point)
    # device time of each call alone, the L2 flushed before it: at 64^3
    # and below, back-to-back calls time the host's enqueue rate
    print("  kernel 1 plain mode, the first design (v1) and the shipped one "
          "in turns (median device ms of 2 x 20 calls each, L2 flushed "
          "before each):")
    flush6 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def times6(fn):
        return cuda_flushed_times_ms(fn, flush6)

    rng6 = np.random.default_rng(SEED + 6)
    A_ldc = gen.poisson2d(256, dtype=np.float64).to(dev)
    cases6 = [(f"f32 poisson3d_27pt({MAIN_NX})", A, x),
              (f"f64 poisson3d_27pt({F64_NX})", A64, x64),
              (f"f64 poisson3d_27pt({MAIN_NX})", A64L, x64L_true),
              ("f64 poisson2d(256) (the LDC's shape)", A_ldc,
               torch.from_numpy(rng6.standard_normal(256 ** 2)).to(dev))]
    A_bf = A.with_data(A.data.to(torch.bfloat16))
    cases6 += [(f"bf16_f32 poisson3d_27pt({MAIN_NX})", A_bf, x),
               (f"bf16 poisson3d_27pt({MAIN_NX})", A_bf,
                x.to(torch.bfloat16))]
    kernel1_turns(cases6, times6)
    D6 = torch.from_numpy(np.exp(1j * rng6.uniform(0, 2 * np.pi, n))).to(dev)
    for dt, key in ((torch.complex64, "c64"), (torch.complex128, "c128")):
        A_c = unitary_similarity(A if dt == torch.complex64 else A64L, D6)
        x_c = torch.from_numpy(rng6.standard_normal(n)
                               + 1j * rng6.standard_normal(n)).to(dev, dt)
        kernel1_turns([(f"{key} D^H A D at {MAIN_NX}^3", A_c, x_c)],
                      times6)
        del A_c, x_c
    del cases6, A_bf, A_ldc, D6, flush6
    torch.cuda.empty_cache()

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
                                st.scal, st.pap_part, st.work)
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
                 st.pap_part, st.work)),
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

    solve_times = {}
    for label, fn, plain in rows:
        ms = solve_ms(fn)
        solve_times[label] = ms
        pms = solve_ms(plain) if plain is not None else None
        its = fn()
        pits = plain() if plain is not None else None
        print(f"  solve {label:30s} {fmt(ms)} {its} it;   plain "
              + (f"{fmt(pms)} {pits} it" if pms is not None
                 else "not measured (no plain refinement loop)"),
              flush=True)

    A_cg, A64_cg = A, A64   # kernel 1 was timed on these
    b_cg = b                # cg_110M's right-hand side, for phase (13)
    b_main = b              # and for phase (26)
    del A64L, b64L, x64L_true
    torch.cuda.empty_cache()
    main_runs = {"phases (4)-(5)": main_launches}

    def counts():
        return {**cuda_spmv.LAUNCHES, **cuda_cg.LAUNCHES,
                **cuda_bicgstab.LAUNCHES, **cuda_cwell.LAUNCHES,
                **cuda_bell.LAUNCHES, **cuda_cwell.PLAN_COUNTS}

    reset_counts = tracing.reset

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
    bound("dia_spmv_f32", n, nd, 2, 0, 4)
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
    for k in ("dia_spmv_f32", "dia_spmv_ext_f32", "dia_spmv_f64",
              "dia_spmv_ext_f64", "dia_cg_spmv_dot", "dia_cg_update",
              "dia_bicgstab_q", "dia_bicgstab_t", "dia_bicgstab_update"):
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
    def times(fn, inner, reps=5, warmup=None):
        if warmup is None:
            warmup = 1 if inner == 1 else 2
        ts = cuda_times_ms(fn, warmup=warmup, reps=reps, inner=inner)
        return float(np.median(ts)), min(ts), max(ts)

    systems = general_structure_phases(
        dev, MAIN_NX, note=note, counts=counts, reset_counts=reset_counts,
        main_runs=main_runs, times=times, cg_dia_iters=solves[None],
        A_cg=A_cg, b_cg=b_cg, A_cd=A, b_cd=b)
    systems.update(b=b_cg, b_cd=b)  # for phases (22)-(23)
    del A, b, A_cg, b_cg, A64, b64, A64_cg, op, bx
    torch.cuda.empty_cache()

    # ---- (15)-(18) the multi-RHS path (K6/K7, K8) ------------------------
    errs = spmm_kernel_phases(dev)
    multirhs_phases(dev, systems, note=note, counts=counts,
                    reset_counts=reset_counts, main_runs=main_runs,
                    times=times, results=results, edge_errs=errs)
    for k in ("A", "W64", "A64_dia"):
        del systems[k]
    torch.cuda.empty_cache()

    # ---- (19)-(21) AMG, the preconditioners and the lid-driven cavity ----
    amg_phases(dev, systems, counts=counts, reset_counts=reset_counts,
               main_runs=main_runs, times=times, cg_iters=solves[None])

    # ---- (22)-(23) single-reduction CG, FCG, MINRES, FGMRES; callables ---
    more_solver_phases(dev, systems, counts=counts,
                       reset_counts=reset_counts, main_runs=main_runs,
                       times=times, cg_iters=solves[None])
    systems.clear()
    torch.cuda.empty_cache()

    # ---- (24)-(25) the direct solvers and the LDC's direct path ----------
    direct_phases(dev, counts=counts, reset_counts=reset_counts,
                  main_runs=main_runs, times=times)

    # ---- (26) the distributed solvers on an NCCL group of one rank ------
    dist_phases(dev, b_main, counts=counts, reset_counts=reset_counts,
                main_runs=main_runs, times=times, cg_iters=solves[None],
                fused_ms=solve_times["cg f32 M=None (fused)"])

    # ---- (27) ILU(0): host factor, level-scheduled sweeps ----------------
    ilu_phases(dev, b_main, counts=counts, reset_counts=reset_counts,
               main_runs=main_runs, times=times, cg_iters=solves[None],
               jacobi_iters=solves["jacobi"],
               fused_ms=solve_times["cg f32 M=None (fused)"])

    # ---- (28) native complex ---------------------------------------------
    complex_phases(dev, b_main, note=note, counts=counts,
                   reset_counts=reset_counts, main_runs=main_runs,
                   times=times, cg_iters=solves, nonsym_iters=nonsym)
    torch.cuda.empty_cache()

    # ---- (29) bf16 -----------------------------------------------------
    bf16_phases(dev, b_main, note=note, counts=counts,
                reset_counts=reset_counts, main_runs=main_runs, times=times,
                fused_ms=solve_times["cg f32 M=None (fused)"])
    torch.cuda.empty_cache()

    # ---- (30) the tooling and the rest of the public API -----------------
    tooling_phases(dev, b_main, x_cg, counts=counts,
                   reset_counts=reset_counts, main_runs=main_runs,
                   cg_iters=solves[None],
                   kernel1_ms=results["dia_spmv_f32"]["ms"])
    del b_main, x_cg

    # ---- results -----------------------------------------------------------
    src_spmv = "tpu_sparse_torch/csrc/dia_spmv.cu"
    src_cg = "tpu_sparse_torch/csrc/dia_cg.cu"
    src_bicg = "tpu_sparse_torch/csrc/dia_bicgstab.cu"
    k10 = "tpu_sparse/kernels/pallas_bicgstab.py:52"
    origin = {
        "dia_spmv_f32": (src_spmv, "tpu_sparse/kernels/pallas_spmv.py:51"),
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
        "dia_spmv_c64": (src_spmv, "tpu_sparse/kernels/pallas_spmv.py:51"),
        "dia_spmv_c128": (src_spmv, "tpu_sparse/kernels/pallas_spmv.py:51"),
        "cwell_spmv_c64": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:48"),
        "cwell_spmv_c128": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                            "tpu_sparse/kernels/pallas_cwell.py:307"),
        "cwell_spmm_c64": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                           "tpu_sparse/kernels/pallas_cwell.py:639"),
        "cwell_spmm_c128": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                            "tpu_sparse/kernels/pallas_cwell.py:505"),
        "bell_spmm_c64": ("tpu_sparse_torch/csrc/bell_spmm.cu",
                          "tpu_sparse/kernels/pallas_bell.py:34"),
        "bell_spmm_c128": ("tpu_sparse_torch/csrc/bell_spmm.cu",
                           "tpu_sparse/kernels/pallas_bell.py:34"),
        # bf16 (phase 29): bf16 values with a float32 or a bf16 operand
        "dia_spmv_bf16_f32": (src_spmv,
                              "tpu_sparse/kernels/pallas_spmv.py:51"),
        "dia_spmv_bf16": (src_spmv, "tpu_sparse/kernels/pallas_spmv.py:51"),
        "dia_spmv_ext_bf16_f32": (src_spmv,
                                  "tpu_sparse/kernels/pallas_spmv.py:279"),
        "dia_spmv_ext_bf16": (src_spmv,
                              "tpu_sparse/kernels/pallas_spmv.py:279"),
        "cwell_spmv_bf16_f32": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                                "tpu_sparse/kernels/pallas_cwell.py:48"),
        "cwell_spmv_bf16": ("tpu_sparse_torch/csrc/cwell_spmv.cu",
                            "tpu_sparse/kernels/pallas_cwell.py:48"),
        "cwell_spmm_bf16_f32": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                                "tpu_sparse/kernels/pallas_cwell.py:639"),
        "cwell_spmm_bf16": ("tpu_sparse_torch/csrc/cwell_spmm.cu",
                            "tpu_sparse/kernels/pallas_cwell.py:639"),
        "bell_spmm_bf16_f32": ("tpu_sparse_torch/csrc/bell_spmm.cu",
                               "tpu_sparse/kernels/pallas_bell.py:34"),
        "bell_spmm_bf16": ("tpu_sparse_torch/csrc/bell_spmm.cu",
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
    """Phases (15)-(16): K6/K7 against ``reference.cwell_compact_spmm`` on
    the compact plan, and each of its columns against K4/K5 bit for bit;
    K8 against ``reference.bell_spmm``; on edge cases, float32 within 1e-5
    and float64 within 1e-12 of max|Y|, reruns bit-identical, and the
    wrappers' refusals. Returns the largest abs error per kernel name."""
    import scipy.sparse as sp
    import torch

    from tpu_sparse_torch.kernels import _cwellseg_apply, cuda_bell, \
        cuda_cwell, spmm
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr, cwell_compact
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse.cwell import (csr_to_cwell,
                                               csr_to_cwell_segments)

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
        return Y1, err

    def compact_spmm(W_, B_):
        return ref.cwell_compact_spmm(*cwell_compact.compact(W_), B_)

    def columns_equal_k4(W_, B_, Y_):
        return all(torch.equal(Y_[:, j], cuda_cwell.cwell_spmv_cuda(
            W_, B_[:, j].contiguous())) for j in range(B_.shape[1]))

    # ---- (15) K6/K7 ----------------------------------------------------
    phase("(15) K6/K7 (cwell_spmm) against reference.cwell_compact_spmm on "
          "edge cases; every column against K4/K5 bit for bit")
    ks = (1, 7, 8, 33, 129)

    def empty_rows_and_columns(n_, m_, per_row, dt):
        Ad = random_csr(n_, m_, per_row, dt).todense()
        Ad[100:300] = 0
        Ad[:, 50:400] = 0
        return conv.dense_to_csr(Ad)

    def long_rows(n_, m_, per_row, dt):
        Ad = random_csr(n_, m_, per_row, dt).todense()
        Ad[5] = torch.arange(1, m_ + 1, dtype=Ad.dtype, device=dev)
        return conv.dense_to_csr(Ad)

    def long_row_narrow(n_, m_, per_row, dt):
        Ad = random_csr(n_, m_, per_row, dt).todense()
        Ad[5, torch.from_numpy(rng.choice(m_, 150, replace=False))] = 1.5
        return conv.dense_to_csr(Ad)

    for label, make, n_, m_, per_row, groups in (
            ("random 3000x2500", random_csr, 3000, 2500, 8, (1, 2, 4)),
            ("n, m not x128: 1001x777", random_csr, 1001, 777, 7, (1,)),
            ("m < 256: 300x200", random_csr, 300, 200, 5, (1, 2)),
            ("empty 300x300", random_csr, 300, 300, 0, (1,)),
            ("empty rows, columns 1500x1400", empty_rows_and_columns, 1500,
             1400, 6, (1, 2)),
            ("a row of 150 in 300x2500", long_row_narrow, 300, 2500, 4,
             (1,)),
            ("long rows 300x600 (wide plan)", long_rows, 300, 600, 4,
             (1,))):
        for dt in (np.float32, np.float64):
            A_ = make(n_, m_, per_row, dt)
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
                plan = cwell_compact.compact(W)[0]
                check(plan.wide == label.startswith("long rows"),
                      f"{label}: the plan's index width")
                errs, cols = [], True
                for k in ks:
                    B = torch.from_numpy(rng.standard_normal((m_, k)).astype(
                        dt)).to(dev)
                    Y, err = check_spmm(f"{label} Q={Q} k={k}",
                                        cuda_cwell.cwell_spmm_cuda,
                                        compact_spmm, W, B, "cwell_spmm")
                    errs.append(err)
                    cols &= columns_equal_k4(W, B, Y)
                check(cols, f"K6/K7 columns differ from K4/K5 on {label}")
                print(f"  {label:30s} {str(np.dtype(dt)):7s} Q={Q} S="
                      f"{W.planes:<4d} depth {plan.depth:3d}"
                      f"{' int32 cols' if plan.wide else ''}: k={ks} max abs "
                      f"err {max(errs):.2e}; columns == K4/K5: {cols}")
    # a CWELLSeg: one launch per segment through the dispatch
    for dt in (np.float32, np.float64):
        Seg = csr_to_cwell_segments(random_csr(600, 1500, 9, dt),
                                    seg_cols=256)
        errs = []
        for k in (1, 8, 33):
            B = torch.from_numpy(rng.standard_normal((1500, k)).astype(
                dt)).to(dev)
            sfx = "cwell_spmm_f" + str(B.dtype)[-2:]
            before = cuda_cwell.LAUNCHES[sfx]
            errs.append(check_spmm(
                f"CWELLSeg k={k}", spmm,
                lambda A_, X: _cwellseg_apply(A_, X, compact_spmm), Seg, B,
                "cwell_spmm")[1])
            check(cuda_cwell.LAUNCHES[sfx] - before == 2 * len(Seg.segments),
                  "a CWELLSeg SpMM did not launch K6/K7 once per segment")
        print(f"  CWELLSeg 600x1500, {len(Seg.segments)} segments, "
              f"{str(np.dtype(dt)):7s}: k=(1, 8, 33) max abs err "
              f"{max(errs):.2e}")

    # ---- (16) K8 -------------------------------------------------------
    phase("(16) K8 (bell_spmm) against the plain version on edge cases")
    for nb, bs, density, pad in ((40, 8, 0.2, 0), (40, 8, 0.2, 5),
                                 (50, 1, 0.1, 3), (30, 3, 0.3, 2),
                                 (12, 16, 0.5, 1), (6, 64, 0.5, 1)):
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
            for k in (1, 7, 8, 33):
                B = torch.from_numpy(rng.standard_normal((nb * bs, k))).to(
                    dev, dt)
                errs.append(check_spmm(f"bs={bs} L={L} k={k}",
                                       cuda_bell.bell_spmm_cuda,
                                       ref.bell_spmm, bell, B,
                                       "bell_spmm")[1])
            print(f"  {nb} block rows, bs={bs}, L={L} ({pad} padding "
                  f"blocks), {str(dt)[6:]}: k=(1, 7, 8, 33) max abs err "
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
    from tpu_sparse_torch.sparse import CWELL, DIA, cwell_compact
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse import to_gpu_operator
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
        """K4/K5 against their plain version (reference.cwell_compact_spmv
        on W's compact plan) and the plane reference (reference.cwell_spmv):
        max abs error <= bound * max|y| (exactly 0 where y is 0); a rerun
        gives the same bits. Returns the error against the plain version."""
        plan, cvals = cwell_compact.compact(W)
        y0 = ref.cwell_compact_spmv(plan, cvals, x)
        yp = ref.cwell_spmv(W, x)
        y1 = cuda_cwell.cwell_spmv_cuda(W, x)
        y2 = cuda_cwell.cwell_spmv_cuda(W, x)
        torch.cuda.synchronize()
        scale = float(yp.abs().max()) if yp.numel() else 0.0
        err = float((y1 - y0).abs().max()) if y0.numel() else 0.0
        err_p = float((y1 - yp).abs().max()) if yp.numel() else 0.0
        name = str(x.dtype).replace("torch.", "")
        print(f"  {label:34s} {name} S={W.planes:<4d} fill {W.fill:.3f} "
              f"Q={W.group}: plan {plan.slots} slots"
              f"{' (int32 columns)' if plan.wide else ''}; max abs err "
              f"{err:.2e}, to the plane reference {err_p:.2e} (max|y| "
              f"{scale:.2e})")
        check(max(err, err_p) <= bound[x.dtype] * scale,
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
            if label.startswith("random"):
                # a pack carried in JAX's layout, as numpy arrays
                Wh = csr_to_cwell(A_.to("cpu"), group=4)
                check_cwell(f"{label}, carried pack", conv.cwell_from_numpy(
                    Wh.vals.numpy(), Wh.idx2.numpy(), Wh.srow.numpy(),
                    Wh.shape, nnz=Wh.nnz, fill=Wh.fill, group=4,
                    device=dev), x_)
    # more than 256 planes (one row over three windows): int32 columns
    for dt in (np.float32, np.float64):
        Ad = random_csr(300, 600, 4, dt).todense()
        Ad[5] = torch.arange(1, 601, dtype=Ad.dtype, device=dev)
        Ww = csr_to_cwell(conv.dense_to_csr(Ad))
        check(Ww.planes > 256 and cwell_compact.compact(Ww)[0].wide,
              "the long-row pack did not take the int32-column plan")
        check_cwell("long rows 300x600", Ww, torch.from_numpy(
            rng.standard_normal(600).astype(dt)).to(dev))
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

    def run(label, W_, b_, truth, tol, carriers, limit, gathers=1,
            **kw):
        """One solve: converged, its true residual within ``limit``, the
        carriers launched, at most one compact plan built (one pack
        structure a solve) and at most ``gathers`` value gathers (one a
        values tensor), the iteration count of the plane-walking kernel's
        runs where one is recorded."""
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
        check(grew.get("plan_builds", 0) <= 1
              and grew.get("value_gathers", 0) <= gathers,
              f"{label}: compact plans rebuilt within the solve")
        want = PLANE_KERNEL_ITERS.get(label) if nx == MAIN_NX else None
        if want is not None:
            # f64 sums as the plane kernel did: the same count; f32 within
            # the slack of the card tests
            slack = 0 if "f64" in label else max(5, want // 5)
            check(abs(res.iterations - want) <= slack,
                  f"{label}: {res.iterations} iterations against {want}")
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
        gathers=2, method="cg", precision="auto")

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
        check(grew.get("plan_builds", 0) <= 1
              and grew.get("value_gathers", 0) <= 1,
              f"{method} backward rebuilt compact plans")

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

    # the compact plan of the f32 pack, built anew: build time, gather
    # time and the memory it holds beside the pack
    cwell_compact.clear_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = cwell_compact.build_plan(W)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    t_gather = times(lambda: cwell_compact.gather_values(plan, W.vals), 5)
    del plan
    cwell_compact.clear_caches()
    xk = torch.from_numpy(np.random.default_rng(SEED + 14).standard_normal(
        n).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    cuda_cwell.cwell_spmv_cuda(W, xk)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem0
    peak_spmv = torch.cuda.max_memory_allocated() - mem0
    plan, cvals = cwell_compact.compact(W)
    print(f"  compact plan of the {nx}^3 f32 pack: {plan.slots} slots for "
          f"{W.nnz} entries ({W.vals.numel()} in the pack); build "
          f"{t_plan * 1e3:.1f} ms (wall) with a peak of {peak / 1e6:.1f} MB "
          f"above the pack; value gather {fmt(t_gather)}; held beside the "
          f"pack {held / 1e6:.1f} MB (plan {plan.nbytes / 1e6:.1f} MB, "
          f"compact values {cvals.numel() * 4 / 1e6:.1f} MB); device "
          f"memory allocated without the plan {mem0 / 1e9:.3f} GB, with it "
          f"{(mem0 + held) / 1e9:.3f} GB, peak of the first K4 call (plan "
          f"build included) {(mem0 + peak_spmv) / 1e9:.3f} GB")
    del plan, cvals

    for key, W_, Ac in (("cwell_spmv_f32", W, A),
                        ("cwell_spmv_f64", W64, A64)):
        dt = W_.vals.dtype
        xk = torch.from_numpy(np.random.default_rng(SEED + 14)
                              .standard_normal(n)).to(dev, dt)
        err = check_cwell(f"poisson3d_27pt({nx}) pack", W_, xk)
        plan, cvals = cwell_compact.compact(W_)
        t_k = times(lambda: cuda_cwell.cwell_spmv_cuda(W_, xk), 10)
        t_p = times(lambda: ref.cwell_compact_spmv(plan, cvals, xk), 2)
        lib = torch.sparse_csr_tensor(Ac.indptr, Ac.indices, Ac.data,
                                      size=Ac.shape)
        e_lib = rel_err(torch.mv(lib, xk), ref.cwell_spmv(W_, xk))
        check(e_lib <= (1e-5 if dt == torch.float32 else 1e-12),
              "the CSR yardstick computes another function")
        t_l = times(lambda: torch.mv(lib, xk), 10)
        size = W_.vals.element_size()
        nb, S = W_.srow.shape
        # the compact kernel's bytes: values and 2-byte indices of the
        # plan's slots, the block offsets, the window rows, x and y
        nbytes = (plan.slots * (size + plan.idx.element_size())
                  + plan.boff.numel() * 8 + nb * S * 4
                  + (W_.shape[0] + W_.shape[1]) * size)
        pack_bytes = (W_.vals.numel() * (size + 4) + nb * S * 4
                      + (W_.shape[0] + W_.shape[1]) * size)
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = 2 * W_.nnz / (67e12 if size == 4 else 34e12) * 1e3
        note(key, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
             library_ms=t_l[0], bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"  {key}: kernel {fmt(t_k)}; bound {max(t_bytes, t_ops):.4f}"
              f" ms ({nbytes / 1e6:.1f} MB, {max(t_bytes, t_ops) / t_k[0]:.2f}"
              f" of it; the plane pack's bytes {pack_bytes / 1e6:.1f} MB, "
              f"bound {pack_bytes / 3.35e9:.4f} ms); plain {fmt(t_p)}; "
              f"cuSPARSE CSR matvec {fmt(t_l)} (rel err {e_lib:.1e}); "
              f"kernel / cuSPARSE {t_k[0] / t_l[0]:.2f}; "
              f"{W_.nnz / (t_k[0] * 1e-3) / 1e9:.2f} Gnnz/s", flush=True)
        del lib, plan, cvals

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
    from tpu_sparse_torch.kernels.spmm_probe import (bell_bytes, cwell_bytes,
                                                     kron_bell)
    from tpu_sparse_torch.solvers.batched import cols_norm
    from tpu_sparse_torch.sparse import cwell_compact

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
        if label in MULTI_RHS_ITERS:
            check(res.iterations == MULTI_RHS_ITERS[label],
                  f"{label}: {res.iterations} iterations, recorded "
                  f"{MULTI_RHS_ITERS[label]}")
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
          "multi-RHS solves beside k single-RHS solves (median and min-max "
          "of 3)")

    def fmt(t):
        return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"

    def spmm_row(key, kernel, plain, A_, csr, k, nbytes, flops, ktag,
                 columns=None):
        """One timed row: ``nbytes(size, k)`` gives the bytes of the bound
        and, or None, those of the plane pack for reference; ``columns(A_,
        Bk, Y)`` checks the kernel's columns against K4/K5."""
        dt = A_.vals.dtype if hasattr(A_, "vals") else A_.blocks.dtype
        Bk = torch.from_numpy(np.random.default_rng(SEED + 18)
                              .standard_normal((A_.shape[1], k))).to(dev, dt)
        Y0, Y1 = plain(A_, Bk), kernel(A_, Bk)
        err = float((Y1 - Y0).abs().max())
        scale = float(Y0.abs().max())
        check(err <= (1e-5 if dt == torch.float32 else 1e-12) * scale,
              f"{key} disagrees with the plain version at k={k}")
        cols = ""
        if columns is not None:
            check(columns(A_, Bk, Y1),
                  f"{key}: a column differs from K4/K5 at k={k}")
            cols = "; every column == K4/K5 bit for bit"
        del Y0, Y1
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                      csr.data.to(dt), size=csr.shape)
        e_lib = rel_err(torch.sparse.mm(lib, Bk), plain(A_, Bk))
        check(e_lib <= (1e-5 if dt == torch.float32 else 1e-12),
              "the cuSPARSE yardstick computes another function")
        t_k = times(lambda: kernel(A_, Bk), 5)
        t_p = times(lambda: plain(A_, Bk), 1)
        t_l = times(lambda: torch.sparse.mm(lib, Bk), 5)
        size = torch.finfo(dt).bits // 8
        n_bytes, pack_bytes = nbytes(size, k)
        t_bytes = n_bytes / 3.35e12 * 1e3
        t_ops = flops * k / (67e12 if size == 4 else 34e12) * 1e3
        bound_ms = max(t_bytes, t_ops)
        k4 = results.get(f"cwell_spmv_f{size * 8}", {}).get("ms")
        k4s = "" if k4 is None else f"; {k} x K4 {k * k4:.4f} ms"
        packs = ("" if pack_bytes is None else
                 f"; the plane pack's bound {pack_bytes / 3.35e9:.4f} ms "
                 f"({pack_bytes / 1e6:.1f} MB)")
        print(f"  {key} k={k:3d}: kernel {fmt(t_k)}; bound {bound_ms:.4f} "
              f"ms ({n_bytes / 1e6:.1f} MB, {bound_ms / t_k[0]:.2f} of it)"
              f"{packs}; plain {fmt(t_p)}; cuSPARSE SpMM {fmt(t_l)} (kernel "
              f"/ cuSPARSE {t_k[0] / t_l[0]:.2f}){k4s}; max abs err "
              f"{err:.2e} (max|Y| {scale:.2e}){cols}", flush=True)
        if ktag:
            note(key, max_abs_err=max(err, edge_errs.get(key, 0.0)),
                 ms=t_k[0], plain_ms=t_p[0], library_ms=t_l[0],
                 bound_ms=bound_ms,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        del lib

    def compact_bytes(W_):
        plan = cwell_compact.compact(W_)[0]
        return lambda size, k: cwell_bytes(plan, W_, size, k)

    def compact_spmm(W_, B_):
        return ref.cwell_compact_spmm(*cwell_compact.compact(W_), B_)

    def columns_k4(W_, B_, Y_):
        return all(torch.equal(Y_[:, j], cuda_cwell.cwell_spmv_cuda(
            W_, B_[:, j].contiguous())) for j in range(B_.shape[1]))

    for k in (8, 32, 128):
        spmm_row("cwell_spmm_f32", cuda_cwell.cwell_spmm_cuda, compact_spmm,
                 W, g["A"], k, compact_bytes(W), 2 * W.nnz, k == 8,
                 columns_k4 if k == 8 else None)
    from tpu_sparse_torch.sparse import convert as conv

    A64 = conv.to_csr(g["A64_dia"])
    spmm_row("cwell_spmm_f64", cuda_cwell.cwell_spmm_cuda, compact_spmm,
             W64, A64, 4, compact_bytes(W64), 2 * W64.nnz, True, columns_k4)
    del A64
    for k in (8, 32):
        spmm_row("bell_spmm_f32", cuda_bell.bell_spmm_cuda, ref.bell_spmm,
                 bell, bell_csr, k,
                 lambda size, k: (bell_bytes(bell, size, k), None),
                 2 * bell.blocks.numel(), k == 8)
    spmm_row("bell_spmm_f64", cuda_bell.bell_spmm_cuda, ref.bell_spmm,
             bell64, bell_csr, 4,
             lambda size, k: (bell_bytes(bell64, size, k), None),
             2 * bell64.blocks.numel(), True)

    def multi_and_singles(op, Bm, kw, its):
        """The timed calls; each keeps its iterations in ``its``."""
        def multi():
            its["multi"] = solve(op, Bm, **kw)[1].iterations

        def singles():
            its["singles"] = [
                solve(op, Bm[:, j].contiguous(), **kw)[1].iterations
                for j in range(Bm.shape[1])]
        return multi, singles

    for label, op, Bm, kw, *_ in runs:
        its = {}
        multi, singles = multi_and_singles(op, Bm, kw, its)
        # both ran in phase (17): no warm-up call
        t_m = times(multi, 1, reps=3, warmup=0)
        t_s = times(singles, 1, reps=3, warmup=0)
        print(f"  solve {label:38s} {fmt(t_m)} ({its['multi']} it);   "
              f"{Bm.shape[1]} single-RHS solves {fmt(t_s)} "
              f"({its['singles']} it); ratio {t_s[0] / t_m[0]:.2f}",
              flush=True)


def amg_phases(dev, g, *, counts, reset_counts, main_runs, times, cg_iters,
               nx=MAIN_NX, small_nx=F64_NX, ldc_cmp=(64, 20),
               ldc_run=(256, 50)):
    """Phases (19)-(21): the AMG hierarchy of the nx^3 Poisson system and
    its V-cycle against the plain versions, the AMG and preconditioner
    solves through ``solve()`` (the main path of this slice) and the
    lid-driven cavity on the card. ``g``: the systems of phases (13)-(14)
    (``A_dia`` the f32 DIA, ``W`` its CWELL pack); ``cg_iters``: the plain
    CG iterations of phase (4)."""
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch.apps import ldc as tldc
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.kernels import spmv
    from tpu_sparse_torch.precond import amg as tamg
    from tpu_sparse_torch.precond import fsai_setup
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.containers import CSR
    from tpu_sparse_torch.sparse.cwell import CWELL

    A, W = g["A_dia"], g["W"]
    n = A.shape[0]
    rng = np.random.default_rng(SEED)
    norm = torch.linalg.vector_norm

    def fmt(t):
        return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

    def op_bytes(op):
        ts = [op] if isinstance(op, torch.Tensor) else [
            v for v in vars(op).values() if isinstance(v, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in ts)

    def op_kind(op):
        return "dense" if isinstance(op, torch.Tensor) else type(op).__name__

    # ---- (19) set-up and V-cycle ---------------------------------------
    phase(f"(19) AMG set-up and V-cycle on poisson3d_27pt({nx}) f32 "
          f"({A.nnz} nonzeros): the card's kernels against the plain "
          "versions")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hier = tamg.amg_setup(A)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sizes = [lv.A.shape[0] for lv in hier.levels] + [
        hier.coarse_inv.shape[0]]
    print(f"  set-up (native C++ graph phase, packing on the card) "
          f"{t_setup:.2f} s (wall); {hier.num_levels} levels, sizes {sizes}")
    for k, lv in enumerate(hier.levels):
        parts = []
        for name in ("A", "R", "P"):
            op = getattr(lv, name)
            parts.append(f"{name} {op_kind(op)} {op_bytes(op) / 1e6:.1f} MB")
            if isinstance(op, CSR):
                print(f"  level {k} {name} stays CSR (its CWELL fill is "
                      "below 0.04, as JAX's device branch would keep it): "
                      "plain products")
        print(f"  level {k} (n={lv.A.shape[0]}): " + ", ".join(parts)
              + (" (the caller's)" if k == 0 else ""))
    print(f"  coarse pinv {hier.coarse_inv.shape[0]}^2 "
          f"{op_bytes(hier.coarse_inv) / 1e3:.1f} KB")
    M = tamg.AMGPreconditioner(hier)  # V(1,1), omega 0.9: solve()'s M
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    before = counts()
    y = M(b)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    m1 = torch.cuda.memory_allocated()
    print(f"  hierarchy device memory {(m1 - m0) / 1e6:.1f} MB beyond the "
          "fine matrix (compact plans included); one V-cycle launched "
          f"{grew}")
    check(grew.get("dia_spmv_f32", 0) > 0 and grew.get("cwell_spmv_f32", 0)
          > 0, "the V-cycle did not run kernel 1 and K4")
    y0 = tamg.v_cycle(hier, b, pre_sweeps=1, post_sweeps=1, omega=0.9,
                      plain=True)
    err = float((y - y0).abs().max())
    scale = float(y0.abs().max())
    print(f"  V-cycle on the card against the same hierarchy applied with "
          f"the plain versions: max abs err {err:.2e}, max|y| {scale:.2e} "
          f"({err / scale:.1e} of it)")
    check(err <= 1e-5 * scale, "the V-cycle disagrees with its plain version")
    t_v = times(lambda: M(b), 5)
    t_p = times(lambda: tamg.v_cycle(hier, b, pre_sweeps=1, post_sweeps=1,
                                     omega=0.9, plain=True), 1)
    print(f"  V(1,1)-cycle {fmt(t_v)}; plain {fmt(t_p)}")
    # per level: the level's own work in the cycle (pre-smoothing, the
    # residual, R, P of a coarse correction, post-smoothing), timed alone
    def level_work(lv, rhs, xc):
        x = tamg._smooth(lv.A, lv.dinv_l1, torch.zeros_like(rhs), rhs, 1,
                         0.9)
        tamg._product(lv.R, rhs - tamg._product(lv.A, x))
        x = x + tamg._product(lv.P, xc)
        return tamg._smooth(lv.A, lv.dinv_l1, x, rhs, 1, 0.9)

    per_level = []
    for k, lv in enumerate(hier.levels):
        rk = torch.from_numpy(rng.standard_normal(sizes[k]).astype(
            np.float32)).to(dev)
        xk = torch.zeros(sizes[k + 1], dtype=torch.float32, device=dev)
        per_level.append(times(lambda: level_work(lv, rk, xk), 5)[0])
    ci = hier.coarse_inv
    rc = torch.ones(ci.shape[0], dtype=ci.dtype, device=dev)
    per_level.append(times(lambda: ci @ rc, 5)[0])
    print(f"  V-cycle ms by level (each level's work timed alone; the last "
          f"the coarse pinv product), sum {sum(per_level):.3f}: " + "; ".join(
              f"{k}: {t:.3f}" for k, t in enumerate(per_level)))
    P0 = hier.levels[0].P
    if isinstance(P0, CWELL):
        Pc = P0.tocsr()
        tp = tamg.TentativeP(Pc.data, Pc.indices.long(), P0.shape)
        xc = torch.from_numpy(rng.standard_normal(P0.shape[1]).astype(
            np.float32)).to(dev)
        e_g = float((tp.apply(xc) - spmv(P0, xc)).abs().max())
        check(e_g == 0.0, "K4 on the tentative P differs from the gather")
        t_g, t_4 = times(lambda: tp.apply(xc), 5), times(
            lambda: spmv(P0, xc), 5)
        print(f"  tentative P ({P0.shape[0]} x {P0.shape[1]}, CWELL S="
              f"{P0.planes}): the TentativeP gather {fmt(t_g)}, K4 "
              f"{fmt(t_4)}; equal results")
    del y, y0, M
    # the block V-cycle on the CWELL pack's hierarchy: every level operator
    # one SpMM (K6/K7 on CWELL levels) against the single V-cycles
    t0 = time.perf_counter()
    hier_w = tamg.amg_setup(W)
    torch.cuda.synchronize()
    print(f"  set-up on the {nx}^3 CWELL pack {time.perf_counter() - t0:.2f}"
          f" s (wall), sizes "
          f"{[lv.A.shape[0] for lv in hier_w.levels]}; operators "
          + ", ".join(f"{k}: " + "/".join(op_kind(o) for o in lv[:3])
                      for k, lv in enumerate(hier_w.levels)))
    Mw = tamg.AMGPreconditioner(hier_w)
    K = 8
    B = torch.from_numpy(rng.standard_normal((n, K)).astype(np.float32)).to(
        dev)
    before = counts()
    Y = Mw.matmat(B)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    singles = [Mw(B[:, j].contiguous()) for j in range(K)]
    bitwise = sum(torch.equal(Y[:, j], s) for j, s in enumerate(singles))
    e_b = max(float((Y[:, j] - s).abs().max() / s.abs().max())
              for j, s in enumerate(singles))
    dense = sum(isinstance(lv.A, torch.Tensor) for lv in hier_w.levels) + 1
    print(f"  block V-cycle (k={K}) launched {grew}; columns equal to the "
          f"single V-cycles bit for bit: {bitwise} of {K}; max rel diff "
          f"{e_b:.1e} (the {dense} dense levels multiply by cuBLAS gemm for "
          "a block and gemv for a vector)")
    check(grew.get("cwell_spmm_f32", 0) > 0, "the block V-cycle missed K6/K7")
    check(e_b <= 1e-5, "block V-cycle columns differ from the single ones")
    t_b = times(lambda: Mw.matmat(B), 5)
    t_s = times(lambda: [Mw(B[:, j].contiguous()) for j in range(K)], 1)
    print(f"  block V-cycle {fmt(t_b)}; {K} single V-cycles {fmt(t_s)}")
    del hier, hier_w, Mw, Y, singles, B
    torch.cuda.empty_cache()

    # ---- (20) main path ------------------------------------------------
    phase("(20) main path: AMG and preconditioned solves through solve() "
          f"at {nx}^3 f32 (tol 1e-6) and {small_nx}^3, and the block AMG "
          "solve")
    x_true = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev)
    b = ref.dia_spmv(A, x_true)
    As = gen.poisson3d_27pt(small_nx, device=dev)
    bs = ref.dia_spmv(As, torch.from_numpy(rng.standard_normal(
        As.shape[0]).astype(np.float32)).to(dev))
    A64 = gen.poisson3d_27pt(small_nx, dtype=np.float64, device=dev)
    b64 = ref.dia_spmv(A64, torch.from_numpy(rng.standard_normal(
        A64.shape[0])).to(dev))
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 8)).astype(np.float32)).to(dev)

    def truth(op):
        if op is W:
            return lambda X: (ref.dia_spmm(A, X) if X.dim() == 2
                              else ref.dia_spmv(A, X))
        return lambda x: ref.dia_spmv(op, x)

    rows = [
        # label, operand, rhs, solve() arguments, carriers, residual bound
        ("cg backend=amg", A, b, dict(backend="amg", tol=1e-6),
         ("dia_spmv_f32", "cwell_spmv_f32"), 1e-5),
        ("cg M=amg", A, b, dict(method="cg", M="amg", tol=1e-6,
                                maxiter=500),
         ("dia_spmv_f32", "cwell_spmv_f32"), 1e-5),
        ("stationary backend=amg accelerant=None", A, b,
         dict(backend="amg", accelerant=None, tol=1e-6, maxiter=500),
         ("dia_spmv_f32", "cwell_spmv_f32"), 1e-5),
        ("cg M=chebyshev", A, b, dict(M="chebyshev", tol=1e-6, maxiter=500),
         ("dia_spmv_f32",), 1e-5),
        ("cg M=neumann", A, b, dict(M="neumann", tol=1e-6, maxiter=500),
         ("dia_spmv_f32",), 1e-5),
        ("cg backend=amg on the CWELL pack", W, b,
         dict(backend="amg", tol=1e-6), ("cwell_spmv_f32",), 1e-5),
        (f"cg M=fsai {small_nx}^3", As, bs,
         dict(M="fsai", tol=1e-6, maxiter=500), ("dia_spmv_f32",), 1e-5),
        (f"cg M=amg f64 auto {small_nx}^3", A64, b64,
         dict(M="amg", tol=1e-8, precision="auto"),
         ("dia_spmv_ext_f64", "dia_spmv_f32"), 1e-7),
        ("block cg backend=amg on the CWELL pack, k=8", W, B,
         dict(backend="amg", tol=1e-6), ("cwell_spmm_f32",), 1e-5),
    ]
    solver = tpu_sparse_torch.SparseSolver()
    reset_counts()  # the main-path run of this slice starts here
    firsts = {}
    for label, op, rhs, kw, carriers, limit in rows:
        before = counts()
        t0 = time.perf_counter()
        x, res = solver.solve(op, rhs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        r = rhs - truth(op)(x)
        true_rel = float((norm(r, dim=0) / norm(rhs, dim=0)).max())
        firsts[label] = wall
        print(f"  {label}: {res}; true rel res {true_rel:.2e}; first call "
              f"(set-up included) {wall:.2f} s wall; launches {grew}",
              flush=True)
        check(res.converged, f"{label} did not converge")
        check(true_rel <= limit, f"{label}: true residual {true_rel}")
        check(all(grew.get(k, 0) > 0 for k in carriers),
              f"{label}: {carriers} did not carry the solve")
    main_runs["phase (20)"] = counts()
    print(f"  plain CG (no preconditioner) on the {nx}^3 system took "
          f"{cg_iters} iterations in phase (4)")
    print(f"  launches in the main-path run (phase 20): "
          f"{main_runs['phase (20)']}")
    t0 = time.perf_counter()
    fsai_setup(As)
    t_fsai = time.perf_counter() - t0
    print(f"  fsai_setup at {small_nx}^3 (host numpy) {t_fsai:.2f} s wall; "
          f"the same work at {nx}^3 scales by (n ratio) "
          f"{(nx / small_nx) ** 3:.1f}x, about {t_fsai * (nx / small_nx) ** 3:.0f}"
          " s (arithmetic, not measured)")
    for label, op, rhs, kw, _, _ in rows:
        t = times(lambda: solver.solve(op, rhs, **kw), 1)
        print(f"  solve {label:44s} {fmt(t)} (set-up cached)", flush=True)
    # the device's busy share of one AMG-PCG solve
    print_busy(f"AMG-PCG at {nx}^3", device_busy(
        lambda: solver.solve(A, b, backend="amg", tol=1e-6)))
    del solver, As, bs, A64, b64, B, x, r
    torch.cuda.empty_cache()

    # ---- (21) the lid-driven cavity ------------------------------------
    nxc, steps_c = ldc_cmp
    phase(f"(21) lid-driven cavity: nx={nxc}, Re=400, {steps_c} steps on "
          f"the card against the CPU; nx={ldc_run[0]}, {ldc_run[1]} steps")
    reset_counts()
    for precond in ("jacobi", "amg"):
        cfg = dict(nx=nxc, Re=400.0, solver="cg", precond=precond)
        card = tldc.LDCSolver(tldc.LDCConfig(device="cuda", **cfg))
        st_c = card.run(steps_c)
        cpu = tldc.LDCSolver(tldc.LDCConfig(device="cpu", **cfg))
        st_h = cpu.run(steps_c)
        diff = {k: float((getattr(card, k).cpu() - getattr(cpu, k)).abs()
                         .max()) for k in ("u", "v", "p")}
        print(f"  cg+{precond}: card {st_c['steps_per_s']:.1f} steps/s, "
              f"{st_c['pressure_iters_total']} pressure iterations; CPU "
              f"{st_h['steps_per_s']:.1f} steps/s, "
              f"{st_h['pressure_iters_total']}; max |card - CPU| {diff}; "
              f"mass residual {st_c['mass_residual']:.2e}", flush=True)
        check(max(diff.values()) <= 1e-8,
              f"LDC cg+{precond}: the card's fields differ from the CPU's")
        del card, cpu
    nxr, steps_r = ldc_run
    s = tldc.LDCSolver(tldc.LDCConfig(nx=nxr, Re=400.0, solver="cg",
                                      precond="amg", device="cuda"))
    sizes = [lv.A.shape[0] for lv in s.M.hier.levels]
    st = s.run(steps_r)
    print(f"  nx={nxr} cg+amg (levels {sizes} + coarse "
          f"{s.M.hier.coarse_inv.shape[0]}; "
          + ", ".join(f"{k}: " + "/".join(op_kind(o) for o in lv[:3])
                      for k, lv in enumerate(s.M.hier.levels))
          + f"): {steps_r} steps in {st['elapsed_s']:.2f} s wall, "
          f"{st['steps_per_s']:.2f} steps/s, "
          f"{st['pressure_iters_total'] / steps_r:.1f} pressure iterations "
          f"a step, final mass residual {st['mass_residual']:.2e}",
          flush=True)
    check(st["mass_residual"] < 1e-7, "LDC mass residual above 1e-7")
    main_runs["phase (21)"] = counts()
    print(f"  launches in the main-path run (phase 21): "
          f"{main_runs['phase (21)']}")
    check(main_runs["phase (21)"]["dia_spmv_f64"] > 0,
          "K3 did not carry the LDC pressure solves")
    del s
    torch.cuda.empty_cache()

def midpoint_shift(nx: int) -> float:
    """sigma halfway between the two smallest eigenvalues of
    poisson3d_27pt(nx) = 27 I - J (x) J (x) J, J = tridiag(1, 1, 1), whose
    eigenvalues are 27 - prod_i (1 + 2 cos(pi k_i / (nx + 1)))."""
    c1, c2 = (1 + 2 * np.cos(np.pi * k / (nx + 1)) for k in (1, 2))
    return float(27 - c1 * c1 * (c1 + c2) / 2)


def shifted(A, sigma: float):
    """A - sigma I for a DIA matrix."""
    data = A.data.clone()
    data[A.offsets.index(0)] -= sigma
    return A.with_data(data)


def device_busy(run):
    """One call of ``run`` under torch.profiler: (CUDA-event ms, device
    busy ms or None when the profiler saw no device time, the six rows
    with the most device time as (name, ms)). Busy time sums the device's
    own rows (kernels, copies) only: a CPU op's row repeats the device
    time of the kernels it launched, and CUPTI's "Command Buffer Full"
    marks a full launch queue, not device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
    dev_us, busy_us = {}, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev_us[e.key] = us
            if (e.device_type == DeviceType.CUDA
                    and e.key != "Command Buffer Full"):
                busy_us += us
    busy = busy_us / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    return (e0.elapsed_time(e1), busy if busy > 0 else None,
            [(k, v / 1e3) for k, v in top])


def print_busy(label, measured) -> None:
    wall, busy, top = measured
    share = (f"device busy {busy:.2f} ms ({busy / wall:.2f} of it)"
             if busy is not None else "device busy not measured (the "
             "profiler recorded no device time)")
    print(f"  {label} under torch.profiler: {wall:.2f} ms (CUDA events), "
          f"{share}; by kernel (ms): " + "; ".join(
              f"{k[:40]} {v:.2f}" for k, v in top), flush=True)


def more_solver_phases(dev, g, *, counts, reset_counts, main_runs, times,
                       cg_iters, nx=MAIN_NX, small_nx=F64_NX, adj_nx=32,
                       K=8):
    """Phases (22)-(23): single-reduction CG, FCG, MINRES and FGMRES through
    ``solve()`` at nx^3 (DIA: kernel 1; the CWELL packs: K4; f64 'auto' at
    small_nx^3: kernel 1 and K3), each beside its yardstick; then the
    batched forms on the CWELL packs with B of K columns (K6/K7), the
    adjoint of the four methods at adj_nx^3 on the card against the CPU,
    and gradients through matrix-free callables. ``g``: the systems of
    phases (13)-(14) with the right-hand sides of phases (4) (``b``) and
    (8) (``b_cd``); ``cg_iters``: the fused CG's iterations on ``b`` in
    phase (4)."""
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch import autodiff, kernels
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.precond import AMGPreconditioner, amg_preconditioner
    from tpu_sparse_torch.solvers import cg_full
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A, W, A_cd, WC = g["A_dia"], g["W"], g["A_cd"], g["WC"]
    b, b_cd = g["b"], g["b_cd"]
    n = A.shape[0]
    norm = torch.linalg.vector_norm
    solve = tpu_sparse_torch.solve

    def fmt(t):
        return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

    def rhs(op, dtype):
        """b = op @ x_true, x_true from default_rng(SEED), by the plain
        SpMV."""
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            op.shape[0]).astype(dtype)).to(dev)
        return ref.dia_spmv(op, x)

    # ---- (22) set-up -----------------------------------------------------
    sigma, sigma_s = midpoint_shift(nx), midpoint_shift(small_nx)
    phase(f"(22) main path: method='cg_sr' | 'fcg' | 'minres' | 'fgmres' "
          f"through solve() at {nx}^3 f32 (DIA and CWELL) and f64 'auto' at "
          f"{small_nx}^3")
    A_sh = shifted(A, sigma)
    t0 = time.perf_counter()
    W_sh = csr_to_cwell(to_csr(A_sh))
    torch.cuda.synchronize()
    print(f"  minres system A - sigma I, sigma = {sigma:.6f} (halfway between "
          f"the two smallest eigenvalues {27 - (1 + 2 * np.cos(np.pi / (nx + 1))) ** 3:.6f} "
          f"and {2 * sigma - 27 + (1 + 2 * np.cos(np.pi / (nx + 1))) ** 3:.6f}); "
          f"its CWELL pack built in {time.perf_counter() - t0:.2f} s wall")
    t0 = time.perf_counter()
    M03 = amg_preconditioner(A, pre_sweeps=0, post_sweeps=3)
    M03_cd = amg_preconditioner(A_cd, pre_sweeps=0, post_sweeps=3)
    torch.cuda.synchronize()
    print(f"  two AMG set-ups (V(0,3) cycles of both {nx}^3 systems) "
          f"{time.perf_counter() - t0:.2f} s wall; levels "
          f"{[lv.A.shape[0] for lv in M03.hier.levels]} and "
          f"{[lv.A.shape[0] for lv in M03_cd.hier.levels]}")
    M11 = AMGPreconditioner(M03.hier)  # backend='amg''s V(1,1): yardstick
    A64 = gen.poisson3d_27pt(small_nx, dtype=np.float64, device=dev)
    A64_sh = shifted(A64, sigma_s)
    A64_cd = gen.convection_diffusion_3d_27pt(small_nx, dtype=np.float64,
                                              device=dev)
    b64, b64_cd = rhs(A64, np.float64), rhs(A64_cd, np.float64)
    print(f"  f64 minres at {small_nx}^3: sigma = {sigma_s:.6f}")

    f32, k1 = ("cwell_spmv_f32",), ("dia_spmv_f32",)
    auto = ("dia_spmv_ext_f64", "dia_spmv_ext_f32")
    dense = lambda op: (lambda v: ref.dia_spmv(op, v))  # noqa: E731
    rows = [
        # label, operand, rhs, solve() arguments, carriers, true residual
        # bound (float32: the solvers' 10x relaxed contract), truth
        ("cg_sr f32", A, b, dict(method="cg_sr", tol=1e-6, maxiter=500),
         k1, 1e-5, dense(A)),
        ("cg_sr f32 M=jacobi", A, b,
         dict(method="cg_sr", M="jacobi", tol=1e-6, maxiter=500), k1, 1e-5,
         dense(A)),
        ("fcg f32", A, b, dict(method="fcg", tol=1e-6, maxiter=500), k1,
         1e-5, dense(A)),
        ("fcg f32 M=V(0,3)", A, b,
         dict(method="fcg", M=M03, tol=1e-6, maxiter=500),
         k1 + f32, 1e-5, dense(A)),
        (f"minres f32 (A - {sigma:.4f} I)", A_sh, b,
         dict(method="minres", tol=1e-5, maxiter=3000), k1, 1e-4,
         dense(A_sh)),
        ("fgmres(20) f32", A_cd, b_cd,
         dict(method="fgmres", restart=20, tol=1e-6, maxiter=500), k1,
         1e-5, dense(A_cd)),
        ("fgmres(20) f32 M=V(0,3)", A_cd, b_cd,
         dict(method="fgmres", restart=20, M=M03_cd, tol=1e-6,
              maxiter=500), k1 + f32, 1e-5, dense(A_cd)),
        (f"cg_sr f64 auto {small_nx}^3", A64, b64,
         dict(method="cg_sr", tol=1e-8), auto, 1e-8, dense(A64)),
        (f"fcg f64 auto {small_nx}^3", A64, b64,
         dict(method="fcg", tol=1e-8), auto, 1e-8, dense(A64)),
        (f"minres f64 auto {small_nx}^3", A64_sh, b64,
         dict(method="minres", tol=1e-8), auto, 1e-8, dense(A64_sh)),
        (f"fgmres(20) f64 auto {small_nx}^3", A64_cd, b64_cd,
         dict(method="fgmres", restart=20, tol=1e-8), auto, 1e-8,
         dense(A64_cd)),
        ("cg_sr f32 on CWELL", W, b,
         dict(method="cg_sr", tol=1e-6, maxiter=500), f32, 1e-5, dense(A)),
        ("fcg f32 on CWELL", W, b, dict(method="fcg", tol=1e-6, maxiter=500),
         f32, 1e-5, dense(A)),
        ("minres f32 on CWELL", W_sh, b,
         dict(method="minres", tol=1e-5, maxiter=3000), f32, 1e-4,
         dense(A_sh)),
        ("fgmres(20) f32 on CWELL", WC, b_cd,
         dict(method="fgmres", restart=20, tol=1e-6, maxiter=500), f32,
         1e-5, dense(A_cd)),
    ]
    solver = tpu_sparse_torch.SparseSolver()
    reset_counts()  # the main-path run of this slice starts here
    its = {}
    for label, op, rhs_, kw, carriers, limit, truth in rows:
        before = counts()
        t0 = time.perf_counter()
        x, res = solver.solve(op, rhs_, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        true_rel = float(norm(rhs_ - truth(x)) / norm(rhs_))
        its[label] = res.iterations
        print(f"  {label}: {res}; true rel res {true_rel:.2e}; first call "
              f"{wall * 1e3:.1f} ms wall; launches {grew}", flush=True)
        check(res.converged, f"{label} did not converge")
        check(true_rel <= limit, f"{label}: true residual {true_rel}")
        check(all(grew.get(k, 0) > 0 for k in carriers),
              f"{label}: {carriers} did not carry the solve")
        # a new pack builds its plan once; the AMG hierarchy's 14 CWELL
        # operators build theirs in the first V(0,3) solve
        on_pack = any(op is w for w in (W, W_sh, WC))
        check(not on_pack or grew.get("plan_builds", 0) <= 1,
              f"{label}: more than one compact plan built in the solve")
    main_runs["phase (22)"] = counts()
    print(f"  launches in the main-path run (phase 22): "
          f"{main_runs['phase (22)']}")
    # the yardsticks' iteration counts (not on the main path)
    cg_plain = int(cg_full(A, b, tol=1e-6, maxiter=500)[2])
    gm = solve(A_cd, b_cd, method="gmres", restart=20, tol=1e-6,
               maxiter=500)[1].iterations
    print(f"  iterations: cg_sr {its['cg_sr f32']} against the fused CG's "
          f"{cg_iters}; fcg {its['fcg f32']} against cg_full's {cg_plain} "
          f"on kernel 1; fgmres(20) {its['fgmres(20) f32']} cycles against "
          f"gmres(20)'s {gm}")
    check(abs(its["cg_sr f32"] - cg_iters) <= 2,
          "cg_sr iterations differ from the fused CG's by more than 2")
    check(abs(its["fcg f32"] - cg_plain) <= 2,
          "fcg iterations differ from cg_full's by more than 2")
    check(abs(its["fgmres(20) f32"] - gm) <= 1,
          "fgmres cycles differ from gmres's by more than 1")

    yard = {
        "cg_sr f32": ("fused CG", lambda: solve(A, b, tol=1e-6,
                                                maxiter=500)),
        "fcg f32 M=V(0,3)": ("AMG-PCG (cg, V(1,1))", lambda: solve(
            A, b, method="cg", M=M11, tol=1e-6, maxiter=100)),
        "fgmres(20) f32": ("gmres(20)", lambda: solve(
            A_cd, b_cd, method="gmres", restart=20, tol=1e-6,
            maxiter=500)),
    }
    for label, op, rhs_, kw, _, _, _ in rows:
        t = times(lambda: solver.solve(op, rhs_, **kw), 1)
        line = f"  solve {label:34s} {fmt(t)}, {its[label]} it"
        if label in yard:
            name, fn = yard[label]
            line += f";   {name} {fmt(times(fn, 1))}, {fn()[1].iterations} it"
        print(line, flush=True)
    print_busy(f"fcg + V(0,3) at {nx}^3", device_busy(
        lambda: solver.solve(A, b, method="fcg", M=M03, tol=1e-6,
                             maxiter=500)))
    print_busy(f"minres at {nx}^3", device_busy(
        lambda: solver.solve(A_sh, b, method="minres", tol=1e-5,
                             maxiter=3000)))
    del M03, M03_cd, M11, A64, A64_sh, A64_cd, b64, b64_cd, x, solver
    torch.cuda.empty_cache()

    # ---- (23) batched, adjoint, callables --------------------------------
    phase(f"(23) batched solves with B of {K} columns on the {nx}^3 CWELL "
          f"packs; the adjoint at {adj_nx}^3 on the card against the CPU; "
          "gradients through matrix-free callables")
    B = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (n, K)).astype(np.float32)).to(dev)
    truth_mm = {id(W): lambda X: ref.dia_spmm(A, X),
                id(WC): lambda X: ref.dia_spmm(A_cd, X)}
    batched = [
        ("fcg batched M=jacobi", W, dict(method="fcg", M="jacobi", tol=1e-6,
                                         maxiter=500)),
        ("minres batched", W, dict(method="minres", tol=1e-6,
                                   maxiter=500)),
        ("fgmres(20) batched", WC, dict(method="fgmres", restart=20,
                                        tol=1e-6, maxiter=500)),
    ]
    reset_counts()  # the main-path run of this phase starts here
    Xs = {}
    for label, op, kw in batched:
        before = counts()
        X, res = solve(op, B, **kw)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        R = B - truth_mm[id(op)](X)
        true_rel = float((norm(R, dim=0) / norm(B, dim=0)).max())
        print(f"  {label}: {res}; worst column true rel res "
              f"{true_rel:.2e}; launches {grew}", flush=True)
        check(res.converged and true_rel <= 1e-5, f"{label} did not converge")
        check(grew.get("cwell_spmm_f32", 0) > 0
              and grew.get("cwell_spmv_f32", 0) == 0,
              f"{label}: a matvec was not one K6/K7 launch")
        Xs[label] = X
    del R

    # the adjoint of the four methods at adj_nx^3, card against CPU
    rng = np.random.default_rng(SEED + 23)
    adj = {"cg_sr": gen.poisson3d_27pt, "fcg": gen.poisson3d_27pt,
           "minres": lambda m, **kw: shifted(gen.poisson3d_27pt(m, **kw),
                                             midpoint_shift(m)),
           "fgmres": gen.convection_diffusion_3d_27pt}
    for method, make in adj.items():
        Ac = make(adj_nx, device="cpu")
        bc = torch.from_numpy(rng.standard_normal(Ac.shape[0]).astype(
            np.float32))
        # float32 MINRES and FGMRES stop short of 1e-6 on some adjoint
        # systems (A^T v = 1): tol 1e-5, and FGMRES at most 100 cycles
        tol = 1e-5 if method in ("minres", "fgmres") else 1e-6
        maxiter = 100 if method == "fgmres" else 3000
        for fmt_ in ("DIA", "CWELL"):
            Ao = Ac if fmt_ == "DIA" else csr_to_cwell(to_csr(Ac))
            grads = {}
            for where in ("cpu", dev):
                Aw = Ao.to(where)
                vals = (Aw.data if fmt_ == "DIA" else Aw.vals).clone(
                    ).requires_grad_()
                bb = bc.to(where, copy=True).requires_grad_()
                x, res = solve(Aw.with_data(vals), bb, method=method,
                               tol=tol, maxiter=maxiter, precision="full")
                before = counts()
                x.sum().backward()
                torch.cuda.synchronize()
                grew = {k: v - before[k] for k, v in counts().items()
                        if v != before[k]}
                check(res.converged, f"{method} {fmt_} forward on {where}")
                grads[where] = (vals.grad.cpu(), bb.grad.cpu(), grew)
            gA, gb, grew = grads[dev]
            eA = rel_err(gA, grads["cpu"][0])
            eb = rel_err(gb, grads["cpu"][1])
            print(f"  adjoint {method} on {fmt_}: backward launches on the "
                  f"card {grew}; grad rel err card vs CPU: values {eA:.2e}, "
                  f"b {eb:.2e}")
            check(eA <= 5e-3 and eb <= 5e-3,
                  f"{method} {fmt_} adjoint: card and CPU gradients differ")
            carrier = "dia_spmv_f32" if fmt_ == "DIA" else "cwell_spmv_f32"
            check(grew.get(carrier, 0) > 0,
                  f"{method} {fmt_} backward did not launch {carrier}")

    # (a) a callable that launches K4, with A_transpose from the transposed
    # pack, against the matrix path on the same pack
    C = to_csr(gen.convection_diffusion_3d_27pt(adj_nx, device=dev))
    Wn, Wnt = csr_to_cwell(C), csr_to_cwell(to_csr(C.tocoo().T))
    bn = torch.from_numpy(rng.standard_normal(Wn.shape[0]).astype(
        np.float32)).to(dev)
    A_fn = lambda v: kernels.spmv(Wn, v)  # noqa: E731
    At_fn = lambda v: kernels.spmv(Wnt, v)  # noqa: E731
    for method in ("bicgstab", "gmres"):
        fn = getattr(autodiff, f"{method}_diff")
        # float32 GMRES stagnates short of 1e-6 on the adjoint system
        kw = dict(tol=1e-6, maxiter=500) if method == "bicgstab" \
            else dict(tol=1e-5, maxiter=50)
        out = []
        for op, At in ((A_fn, At_fn), (Wn, None)):
            bb = bn.clone().requires_grad_()
            before = counts()
            x, info, _, _ = fn(op, bb, A_transpose=At, **kw)
            x.sum().backward()
            torch.cuda.synchronize()
            grew = counts()["cwell_spmv_f32"] - before["cwell_spmv_f32"]
            check(int(info) == 0, f"callable {method} did not converge")
            check(grew > 0, f"callable {method}: K4 did not carry it")
            out.append((bb.grad, grew))
        e = rel_err(out[0][0], out[1][0])
        print(f"  (a) {method}_diff(lambda v: spmv(W, v), A_transpose=...): "
              f"b.grad against the matrix path's {e:.2e}; K4 launches "
              f"forward + backward {out[0][1]} (matrix path {out[1][1]})")
        check(e <= 1e-3, f"callable {method}: b.grad differs from the "
              "matrix path's")
    # (c) the same callable without A_transpose: K4 has no backward
    bb = bn.clone().requires_grad_()
    x = autodiff.bicgstab_diff(A_fn, bb, tol=1e-6, maxiter=500)[0]
    try:
        x.sum().backward()
        raised = None
    except RuntimeError as err:
        raised = str(err)
    print(f"  (c) without A_transpose: backward raised "
          f"{(raised or 'nothing')[:110]!r}")
    check(raised is not None and "A_transpose=" in raised,
          "a callable without a transpose did not raise naming A_transpose=")

    # (b) a torch-op stencil callable closing over a coefficient tensor
    def stencil(coef, v):
        """(6 + coef) v - (the six neighbours of v) on an adj_nx^3 grid."""
        m = adj_nx
        u = v.reshape(m, m, m)
        out = (6.0 + coef.reshape(m, m, m)) * u
        for d in range(3):
            lo = torch.narrow(u, d, 0, m - 1)
            hi = torch.narrow(u, d, 1, m - 1)
            pad = [0] * 6
            pad[2 * (2 - d)] = 1
            out = out - torch.nn.functional.pad(lo, pad)
            pad = [0] * 6
            pad[2 * (2 - d) + 1] = 1
            out = out - torch.nn.functional.pad(hi, pad)
        return out.reshape(-1)

    coef0 = torch.from_numpy(rng.random(adj_nx ** 3).astype(np.float32))
    bs = torch.from_numpy(rng.standard_normal(adj_nx ** 3).astype(
        np.float32))
    for method in ("cg", "minres"):
        fn = getattr(autodiff, f"{method}_diff")
        grads = {}
        for where in ("cpu", dev):
            coef = coef0.to(where, copy=True).requires_grad_()
            bb = bs.to(where, copy=True).requires_grad_()
            x, info, _, _ = fn(lambda v: stencil(coef, v), bb, tol=1e-6,
                               maxiter=500)
            check(int(info) == 0, f"stencil {method} on {where}")
            x.sum().backward()
            grads[where] = (coef.grad.cpu(), bb.grad.cpu())
        ec = rel_err(grads[dev][0], grads["cpu"][0])
        eb = rel_err(grads[dev][1], grads["cpu"][1])
        print(f"  (b) {method}_diff on a torch-op stencil closing over a "
              f"coefficient: grad rel err card vs CPU: coefficient "
              f"{ec:.2e}, b {eb:.2e}")
        check(ec <= 5e-3 and eb <= 5e-3,
              f"stencil {method}: card and CPU gradients differ")
    main_runs["phase (23)"] = counts()
    print(f"  launches in the main-path run (phase 23): "
          f"{main_runs['phase (23)']}")

    # comparisons and times, after the main-path counts
    for label, op, kw in batched:
        def singles():
            return [solve(op, B[:, j].contiguous(), **kw)[0]
                    for j in range(K)]

        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        xs = singles()
        e1.record()
        torch.cuda.synchronize()
        worst = max(rel_err(Xs[label][:, j], xs[j]) for j in range(K))
        print(f"  {label}: columns against their single-RHS solves: max rel "
              f"difference {worst:.2e}")
        # float32: K6/K7 and the column dot products sum in another order
        # than K4 and torch.vdot, so a column crosses tol some iterations
        # apart and its x differs at the level of the solve's error
        check(worst <= 1e-3, f"{label}: columns differ from single solves")
        ms = times(lambda: solve(op, B, **kw), 1, reps=3, warmup=0)
        t1 = e0.elapsed_time(e1)
        print(f"    batched {fmt(ms)};   {K} single-RHS solves {t1:.2f} ms "
              f"(one run, the check's); ratio {t1 / ms[0]:.2f}", flush=True)
    t = times(lambda: autodiff.bicgstab_diff(
        A_fn, bn.clone().requires_grad_(), A_transpose=At_fn, tol=1e-6,
        maxiter=500)[0].sum().backward(), 1)
    t_m = times(lambda: autodiff.bicgstab_diff(
        Wn, bn.clone().requires_grad_(), tol=1e-6,
        maxiter=500)[0].sum().backward(), 1)
    print(f"  bicgstab_diff forward + backward at {adj_nx}^3: callable with "
          f"A_transpose {fmt(t)}; matrix path {fmt(t_m)}")
    del W_sh, A_sh, Wn, Wnt, B, Xs
    torch.cuda.empty_cache()


DIRECT_NX = 256  # poisson2d(256) + 0.1 triu, n = 65,536 (the JAX bench's
# general_direct_262k system at a quarter of its rows)


def skewed_poisson(nx: int, dtype, dev):
    """poisson2d(nx) + 0.1 triu(poisson2d(nx), 1) in ``dtype`` as a general
    CSR on ``dev`` (the JAX bench's general-direct system,
    bench.py:310-352), and its scipy matrix."""
    import scipy.sparse as sp

    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_scipy_csr

    S = to_scipy_csr(gen.poisson2d(nx, dtype=dtype, device="cpu"))
    S = (S + 0.1 * sp.triu(S, k=1)).tocsr().astype(dtype)
    S.sort_indices()
    return csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                           device=dev), S


def superlu_reference_residual(S, b, leaf=896) -> float:
    """True relative residual of SuperLU's own solve of S x = b with the
    supernodal LU's ordering and options (host scipy, float64; complex128
    for a complex S): the most the level solves of those factors can
    give."""
    import scipy.sparse.linalg as spl

    from tpu_sparse_torch.direct.ordering import nested_dissection

    work = np.complex128 if np.iscomplexobj(S.data) else np.float64
    S = S.astype(work)
    sigma, _ = nested_dissection(S, leaf=leaf)
    lu = spl.splu(S[sigma][:, sigma].tocsc(), permc_spec="NATURAL",
                  diag_pivot_thresh=0.1, options=dict(SymmetricMode=True))
    bb = np.asarray(b, work)
    x = np.empty_like(bb)
    x[sigma] = lu.solve(bb[sigma])
    return float(np.linalg.norm(bb - S @ x) / np.linalg.norm(bb))


def direct_phases(dev, *, counts, reset_counts, main_runs, times,
                  nx=DIRECT_NX, tri_n=500, dense_n=2048, small_nx=128,
                  grad_nx=20, K=8, ldc_cmp=(64, 50), ldc_run=(256, 50)):
    """Phases (24)-(25): the direct solvers through ``solve(...,
    method="direct")`` on the card (Module C). (24): the tridiagonal
    n = tri_n (PCR) against the CPU's Thomas solve, ``dense_solve`` at
    dense_n, the general system ``skewed_poisson(nx)`` in float32 and
    float64 (the supernodal LU: every level group one K4 / K5 launch) and
    with B of K columns (K6/K7), the same system at small_nx^2 (float32
    and float64, SparseLU against the supernodal LU, and the level solve
    against its plain version), level packs against the plain compact
    SpMV / SpMM at their main-path shapes, and the gradients of a solve
    on convection_diffusion_3d_27pt(grad_nx) as CSR, card against CPU. (25):
    the lid-driven cavity with ``solver="direct"`` (block PCR) on the card
    against the CPU, then its steps per second."""
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch import direct
    from tpu_sparse_torch.apps import ldc as tldc
    from tpu_sparse_torch.direct import supernodal
    from tpu_sparse_torch.kernels import cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr

    rng = np.random.default_rng(SEED + 24)
    t_phase = time.perf_counter()

    def fmt(t):
        return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

    def step(what):
        print(f"  [{what}: {time.perf_counter() - t_phase:.0f} s into the "
              "phase]", flush=True)

    def true_rel(S, b, x):
        """Largest ||b - A x|| / ||b|| over the columns, in float64 on the
        host (A in its own dtype's values)."""
        bb = b.detach().double().cpu().numpy()
        R = bb - S.astype(np.float64) @ x.detach().double().cpu().numpy()
        return float(np.max(np.linalg.norm(np.atleast_2d(R.T), axis=-1)
                            / np.linalg.norm(np.atleast_2d(bb.T), axis=-1)))

    def rhs(S, dtype, shape):
        xt = rng.standard_normal(shape).astype(dtype)
        return torch.from_numpy((S.astype(np.float64) @ xt).astype(dtype)
                                ).to(dev)

    def grew_since(before):
        return {k: v - before[k] for k, v in counts().items()
                if v != before[k]}

    def level_packs(lu):
        return [N for P in (lu.packsL, lu.packsU) for g in P if g
                for N in g if N is not None]

    def pack_stats(lu):
        """(levels L / U, groups, plane-pack bytes, compact-plan bytes) of
        a factor's forward packs (plans exist once a solve has run)."""
        packs = level_packs(lu)
        planes = sum(t.numel() * t.element_size() for N in packs
                     for t in (N.vals, N.idx2, N.srow))
        plan = 0
        for N in packs:
            pl, cv = cwell_compact.compact(N)
            plan += pl.nbytes + cv.numel() * cv.element_size()
        return (len(lu.rangesL), len(lu.rangesU), len(packs), planes, plan)

    # ---- (24) the direct solves ----------------------------------------
    phase(f"(24) main path: solve(..., method='direct') on the card: "
          f"tridiagonal n={tri_n} (PCR), dense n={dense_n}, the general "
          f"system poisson2d({nx}) + 0.1 triu as CSR (n = {nx * nx}, "
          f"supernodal LU) in float32 and float64 and with B of {K} "
          f"columns, the same at n = {small_nx ** 2}, gradients")
    A_tri = gen.tridiagonal(tri_n, device=dev)
    b_tri = torch.from_numpy(rng.standard_normal(tri_n)).to(dev)
    Md = rng.standard_normal((dense_n, dense_n)) + 2 * np.sqrt(
        dense_n) * np.eye(dense_n)
    A_dn, b_dn = (torch.from_numpy(Md).to(dev),
                  torch.from_numpy(rng.standard_normal(dense_n)).to(dev))
    systems = {(m, dt): skewed_poisson(m, dt, dev)
               for m in (nx, small_nx) for dt in (np.float32, np.float64)}
    rhs_1 = {key: rhs(S, key[1], S.shape[0])
             for key, (_, S) in systems.items()}
    rhs_k = {key: rhs(S, key[1], (S.shape[0], K))
             for key, (_, S) in systems.items() if key[0] == nx}
    solver = tpu_sparse_torch.SparseSolver()
    factor_s = {}
    for key, (A, _) in systems.items():  # set-up: the host factor, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver._supernodal_lu(A)
        torch.cuda.synchronize()
        factor_s[key] = time.perf_counter() - t0
    step("factors")

    reset_counts()  # the main-path run of this phase starts here
    x_tri, r_tri = tpu_sparse_torch.solve(A_tri, b_tri, method="direct")
    x_dn, r_dn = tpu_sparse_torch.solve(A_dn, b_dn, method="direct")
    out = {}
    for key, (A, S) in systems.items():
        before = counts()
        t0 = time.perf_counter()
        x, r = solver.solve(A, rhs_1[key], method="direct")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        grew = grew_since(before)
        X = rX = grew_k = None
        if key in rhs_k:
            before = counts()
            X, rX = solver.solve(A, rhs_k[key], method="direct")
            torch.cuda.synchronize()
            grew_k = grew_since(before)
        out[key] = (x, r, grew, first_s, X, rX, grew_k)
    C = to_csr(gen.convection_diffusion_3d_27pt(grad_nx, dtype=np.float64,
                                                device="cpu"))
    b_g = torch.from_numpy(rng.standard_normal(C.shape[0]))
    grads = {}
    for where in ("cpu", dev):
        Cw = C.to(where)
        vals = Cw.data.clone().requires_grad_()
        bw = b_g.to(where, copy=True).requires_grad_()
        xg, rg = solver.solve(Cw.with_data(vals), bw, method="direct")
        xg.sum().backward()
        check(rg.converged and rg.residual <= 1e-10,
              f"differentiated direct solve on {where}")
        grads[str(where)] = (vals.grad.cpu(), bw.grad.cpu())
    torch.cuda.synchronize()
    main_runs["phase (24)"] = counts()
    print(f"  launches in the main-path run (phase 24): "
          f"{main_runs['phase (24)']}")
    step("main path")

    # checks, all after the main-path counts
    e_tri = rel_err(x_tri.cpu(), direct.thomas_solve(A_tri.to("cpu"),
                                                     b_tri.cpu()))
    print(f"  tridiagonal n={tri_n} f64 (PCR on the card): {r_tri}; "
          f"against the CPU's Thomas solve {e_tri:.2e}")
    check(r_tri.converged and e_tri <= 1e-10,
          "tridiagonal direct solve: the card's PCR differs from Thomas")
    e_dn = rel_err(x_dn.cpu(), direct.dense_solve(A_dn.cpu(), b_dn.cpu()))
    print(f"  dense n={dense_n} f64: {r_dn}; against the CPU {e_dn:.2e}")
    check(r_dn.converged and e_dn <= 1e-10, "dense direct solve differs")
    ref64 = superlu_reference_residual(systems[nx, np.float64][1],
                                       rhs_1[nx, np.float64].cpu().numpy())
    print(f"  general n={nx * nx}: SuperLU's own float64 solve with the "
          f"supernodal LU's ordering and options: true rel res {ref64:.3e}"
          " (what these factors can give)")
    step("SuperLU reference")
    sfx = {np.float32: "f32", np.float64: "f64"}
    for key, (x, r, grew, first_s, X, rX, grew_k) in out.items():
        m, dt = key
        A, S = systems[key]
        lu = solver._supernodal_lu(A)
        lvL, lvU, groups, planes, plan = pack_stats(lu)
        rel1 = true_rel(S, rhs_1[key], x)
        name = f"{dt.__name__} n={m * m}"
        print(f"  general {name}: factor (host ND + SuperLU + layout, "
              f"packs on the card) {factor_s[key]:.2f} s; levels L {lvL} "
              f"U {lvU}, {groups} level groups; plane packs "
              f"{planes / 1e6:.1f} MB, compact plans {plan / 1e6:.1f} MB; "
              f"first solve {first_s:.3f} s wall", flush=True)
        print(f"    single: {r}; true rel res {rel1:.3e}; launches {grew}")
        check(grew.get(f"cwell_spmv_{sfx[dt]}", 0) > 0,
              f"general direct {name}: no K4/K5 launch")
        if m == small_nx:
            bound = 1e-5 if dt == np.float32 else 1e-10
            check(rel1 <= bound, f"general direct {name}: true relative "
                  f"residual above {bound:g}")
            continue
        relk = true_rel(S, rhs_k[key], X)
        print(f"    B ({K} columns): {rX}; worst column true rel res "
              f"{relk:.3e}; launches {grew_k}", flush=True)
        check(grew_k.get(f"cwell_spmm_{sfx[dt]}", 0) > 0
              and grew_k.get(f"cwell_spmv_{sfx[dt]}", 0) == 0,
              f"general direct {name} with B: a level was not one K6/K7")
        if dt == np.float64:
            check(rel1 <= 10 * ref64 and relk <= 10 * ref64,
                  f"general direct {name}: the level solves lose more than "
                  "10x against SuperLU's own solve of the same factors")
    eA = rel_err(grads[str(dev)][0], grads["cpu"][0])
    eb = rel_err(grads[str(dev)][1], grads["cpu"][1])
    print(f"  gradients of a solve on convection_diffusion_3d_27pt("
          f"{grad_nx}) as CSR, f64 (card: supernodal with transpose packs; "
          f"CPU: host SuperLU): values {eA:.2e}, b {eb:.2e}")
    check(eA <= 1e-10 and eb <= 1e-10,
          "direct gradients: card and CPU differ")

    # the f64 B solve's columns against their single solves (float32
    # factors of this system give no solution to compare); level packs'
    # kernels against the plain compact product at their main-path shapes
    # (the deepest pack and every 32nd); the level solve at small_nx^2
    # against the one on the plain SpMV
    for dt in (np.float32, np.float64):
        A, S = systems[nx, dt]
        X = out[nx, dt][4]
        lu = solver._supernodal_lu(A)
        if dt == np.float64:
            singles = [solver.solve(A, rhs_k[nx, dt][:, j].contiguous(),
                                    method="direct")[0] for j in range(K)]
            worst = max(true_rel(S, rhs_k[nx, dt][:, j], singles[j])
                        for j in range(K))
            diff = max(rel_err(X[:, j], singles[j]) for j in range(K))
            print(f"  float64 n={nx * nx}: {K} single solves' worst true "
                  f"rel res {worst:.3e} (largest x difference from the B "
                  f"solve's columns {diff:.2e})")
            check(worst <= 10 * ref64, "float64 single solves of the B "
                  "columns lose more than 10x against SuperLU's own")
        packs = sorted(level_packs(lu),
                       key=lambda N: -cwell_compact.compact(N)[0].depth)
        sample = packs[:1] + packs[1::32]
        y = torch.from_numpy(rng.standard_normal(lu.n_pad).astype(dt)).to(
            dev)
        Y = torch.from_numpy(rng.standard_normal((lu.n_pad, K)).astype(
            dt)).to(dev)
        e1 = ek = 0.0
        for N in sample:
            pl, cv = cwell_compact.compact(N)
            e1 = max(e1, rel_err(cuda_cwell.cwell_spmv_cuda(N, y),
                                 ref.cwell_compact_spmv(pl, cv, y)))
            ek = max(ek, rel_err(cuda_cwell.cwell_spmm_cuda(N, Y),
                                 ref.cwell_compact_spmm(pl, cv, Y)))
        tol_k = 1e-5 if dt == np.float32 else 1e-12
        print(f"  {dt.__name__} n={nx * nx}: {len(sample)} of {len(packs)} "
              f"level packs (deepest plan "
              f"{cwell_compact.compact(packs[0])[0].depth} slot rows): "
              f"K4/K5 against the plain compact SpMV {e1:.2e}, K6/K7 "
              f"against the plain SpMM {ek:.2e}", flush=True)
        check(e1 <= tol_k and ek <= tol_k,
              f"{dt.__name__} level packs: a kernel differs from its plain "
              "version")
    step("level packs")
    A, S = systems[small_nx, np.float64]
    lu = solver._supernodal_lu(A)
    bp = lu._scatter(rhs_1[small_nx, np.float64], lu.in_idx)
    y_k = supernodal._level_solve(lu.diagL, lu.packsL, lu.metaL, lu.rangesL,
                                  bp, lower=True, transpose=False)
    spmv_kernel = supernodal.spmv
    supernodal.spmv = lambda W, v: ref.cwell_compact_spmv(
        *cwell_compact.compact(W), v)
    try:
        y_p = supernodal._level_solve(lu.diagL, lu.packsL, lu.metaL,
                                      lu.rangesL, bp, lower=True,
                                      transpose=False)
    finally:
        supernodal.spmv = spmv_kernel
    e_lv = rel_err(y_k, y_p)
    print(f"  level solve (L, f64, n={small_nx ** 2}) on K5 against the "
          f"plain compact SpMV: {e_lv:.2e}")
    check(e_lv <= 1e-10, "the level solve differs from its plain version")
    step("checks")

    # SparseLU on the small system against the supernodal LU
    A_s, S_s = systems[small_nx, np.float64]
    b_s = rhs_1[small_nx, np.float64]
    t0 = time.perf_counter()
    slu = direct.SparseLU.factor(A_s)
    torch.cuda.synchronize()
    t_slu = time.perf_counter() - t0
    x_slu = direct.sparse_lu_solve(slu, b_s)
    e_s = rel_err(x_slu, out[small_nx, np.float64][0])
    r_s = true_rel(S_s, b_s, x_slu)
    print(f"  SparseLU n={S_s.shape[0]} f64: factor {t_slu:.2f} s, depths "
          f"{slu.depth_l}/{slu.depth_u}; true rel res {r_s:.2e}; against "
          f"the supernodal solve {e_s:.2e}")
    check(r_s <= 1e-10 and e_s <= 1e-8,
          "SparseLU differs from the supernodal solve")

    # times (CUDA events), after every check
    print(f"  times (CUDA events, median and min-max of 5; "
          f"{torch.cuda.get_device_name(0)}):")
    print(f"    tridiagonal n={tri_n} f64 PCR solve() "
          + fmt(times(lambda: tpu_sparse_torch.solve(
              A_tri, b_tri, method="direct"), 10)))
    print(f"    dense n={dense_n} f64 solve() " + fmt(times(
        lambda: tpu_sparse_torch.solve(A_dn, b_dn, method="direct"), 1)))
    for key, (A, S) in systems.items():
        row = fmt(times(lambda: solver.solve(A, rhs_1[key],
                                             method="direct"), 1))
        if key in rhs_k:
            row += f"; B of {K} columns " + fmt(times(
                lambda: solver.solve(A, rhs_k[key], method="direct"), 1))
        print(f"    general {key[1].__name__} n={key[0] ** 2}: repeat "
              f"solve {row}", flush=True)
        if key[0] == nx:
            print_busy(f"general {key[1].__name__} repeat solve",
                       device_busy(lambda: solver.solve(
                           A, rhs_1[key], method="direct")))
    print("    SparseLU n={} solve {}".format(S_s.shape[0], fmt(times(
        lambda: direct.sparse_lu_solve(slu, b_s), 1))))
    step("times")
    del systems, out, solver, slu, A_dn
    torch.cuda.empty_cache()

    # ---- (25) the lid-driven cavity with solver='direct' ----------------
    nxc, steps_c = ldc_cmp
    nxr, steps_r = ldc_run
    phase(f"(25) lid-driven cavity, solver='direct' (block PCR on the "
          f"card): nx={nxc}, {steps_c} steps on the card against the CPU; "
          f"nx={nxr}, {steps_r} steps")
    cfg = dict(nx=nxc, Re=400.0, solver="direct")
    card = tldc.LDCSolver(tldc.LDCConfig(device="cuda", **cfg))
    st_c = card.run(steps_c)
    cpu = tldc.LDCSolver(tldc.LDCConfig(device="cpu", **cfg))
    st_h = cpu.run(steps_c)
    diff = {k: float((getattr(card, k).cpu() - getattr(cpu, k)).abs().max())
            for k in ("u", "v", "p")}
    print(f"  nx={nxc}: card {st_c['steps_per_s']:.1f} steps/s, CPU "
          f"{st_h['steps_per_s']:.1f} steps/s; max |card - CPU| {diff}; "
          f"mass residual {st_c['mass_residual']:.2e}", flush=True)
    check(max(diff.values()) <= 1e-8,
          "LDC direct: the card's fields differ from the CPU's")
    s = tldc.LDCSolver(tldc.LDCConfig(nx=nxr, Re=400.0, solver="direct",
                                      device="cuda"))
    s.run(2)  # warm-up: cuBLAS / cuSOLVER handles and workspaces
    st = s.run(steps_r)
    print(f"  nx={nxr}: {steps_r} steps in {st['elapsed_s']:.2f} s wall, "
          f"{st['steps_per_s']:.2f} steps/s, final mass residual "
          f"{st['mass_residual']:.2e}", flush=True)
    check(st["mass_residual"] < 1e-7, "LDC direct mass residual above 1e-7")
    del card, cpu, s
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phases(dev, b_main, *, counts, reset_counts, main_runs, times,
                cg_iters, fused_ms, nx=MAIN_NX, small_nx=F64_NX, K=8):
    """Phase (26): ``tpu_sparse_torch.dist`` on a process group of one rank
    (NCCL on the card, gloo on the CPU for a rehearsal): the halo CG on
    cg_110M's system and b (kernel 1 extended mode), the same CG on its
    CWELL pack (K4), float64 at small_nx^3 (extended fp64 kernel 1, K5),
    block CG with B of K columns on the CWELL pack (K6/K7) and AMG-PCG at
    small_nx^3; then kernel checks, times beside the single-device solves
    and the collectives per iteration. ``cg_iters``: phase (4)'s fused CG
    iterations; ``fused_ms``: its (median, min, max) time."""
    import datetime

    import torch
    import torch.distributed as dist

    from tpu_sparse_torch.dist import (comm_model, distributed_block_cg,
                                       distributed_cg, make_row_mesh)
    from tpu_sparse_torch.dist.amg import distributed_amg_preconditioner
    from tpu_sparse_torch.dist.solvers import _shard_and_resolve
    from tpu_sparse_torch.dist.spmv import (HaloCWELL, LocalExtendedOperator,
                                            make_cwell_halo_spmv)
    from tpu_sparse_torch.kernels import cuda_spmv
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.precond.amg import amg_preconditioner
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner
    from tpu_sparse_torch.solvers import block_cg, cg_full
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    rng = np.random.default_rng(SEED + 26)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    phase(f"(26) main path: tpu_sparse_torch.dist on a {backend} group of "
          f"one rank: halo CG on poisson3d_27pt({nx}) f32 (cg_110M's b), "
          f"the same on its CWELL pack, f64 at {small_nx}^3, block CG with "
          f"B of {K} columns, AMG-PCG at {small_nx}^3")
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_row_mesh(dev.type)
        print(f"  {mesh} backend {dist.get_backend()}", flush=True)

        def rel(a, c):
            return float(torch.linalg.vector_norm((a - c).double())
                         / torch.linalg.vector_norm(c.double()))

        A = gen.poisson3d_27pt(nx, device=dev)
        b = b_main
        n = A.shape[0]
        A_csr = to_csr(A)
        A64 = gen.poisson3d_27pt(small_nx, dtype=np.float64, device=dev)
        b64 = A64 @ torch.from_numpy(rng.standard_normal(
            A64.shape[0])).to(dev)
        A64_csr = to_csr(A64)
        A_amg = gen.poisson3d_27pt(small_nx, device=dev)
        b_amg = A_amg @ torch.from_numpy(rng.standard_normal(
            A_amg.shape[0]).astype(np.float32)).to(dev)
        B = torch.from_numpy(rng.standard_normal((n, K)).astype(
            np.float32)).to(dev)
        jac = jacobi_preconditioner(A)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        # -- the main-path run: every launch from here to the read counts
        reset_counts()
        out = {}
        for label, call in (
                ("halo cg f32", lambda: distributed_cg(
                    A, b, mesh=mesh, mode="halo", tol=1e-6, maxiter=500)),
                ("halo cg f32 jacobi", lambda: distributed_cg(
                    A, b, mesh=mesh, mode="halo", tol=1e-6, maxiter=500,
                    M=jac)),
                ("general cg f32", lambda: distributed_cg(
                    A_csr, b, mesh=mesh, tol=1e-6, maxiter=500)),
                ("halo cg f64", lambda: distributed_cg(
                    A64, b64, mesh=mesh, mode="halo", tol=1e-8)),
                ("general cg f64", lambda: distributed_cg(
                    A64_csr, b64, mesh=mesh, tol=1e-8)),
                ("general block cg f32", lambda: distributed_block_cg(
                    A_csr, B, mesh=mesh, tol=1e-6, maxiter=500)),
                ("amg-pcg f32", lambda: distributed_cg(
                    A_amg, b_amg, mesh=mesh, mode="halo", tol=1e-6,
                    M=distributed_amg_preconditioner(A_amg, mesh)))):
            before = counts()
            t0 = time.perf_counter()
            x, info, it, res = call()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in counts().items()
                    if v != before[k]}
            out[label] = (x, int(it))
            print(f"  {label}: info {info.tolist()} iterations {int(it)} "
                  f"residual {res.max().item():.3e} first-call wall "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
                  f"{grew}", flush=True)
            check(bool((info == 0).all()), f"{label}: info {info}")
        main_runs["phase (26)"] = counts()
        print(f"  main-path launches in phase (26): "
              f"{main_runs['phase (26)']}")
        for k in ("dia_spmv_ext_f32", "dia_spmv_ext_f64", "cwell_spmv_f32",
                  "cwell_spmv_f64", "cwell_spmm_f32"):
            check(main_runs["phase (26)"][k] > 0,
                  f"phase (26): {k} did not carry the distributed path")
        if dev.type == "cuda":
            print(f"  peak device memory over the phase's set-up and "
                  f"solves: {torch.cuda.max_memory_allocated() / 1e9:.2f} "
                  f"GB", flush=True)
        for mode in ("gspmd", "halo"):
            A_sh, rmode, _ = _shard_and_resolve(A_csr, mesh, mode)
            print(f"  general operand, mode {mode!r}: route {rmode}, "
                  f"halo plan " + (f"(wl, wr) = ({A_sh.wl}, {A_sh.wr})"
                                   if isinstance(A_sh, HaloCWELL) else
                                   "None (one rank: nothing to exchange; "
                                   "the all_gather route)"))

        # -- against the single-device solves (not counted) --------------
        x_s, info_s, it_s, _ = cg_full(A, b, tol=1e-6, maxiter=500)
        xd, itd = out["halo cg f32"]
        print(f"  halo cg: {itd} iterations, single-device cg_full "
              f"{int(it_s)}, phase (4)'s fused CG {cg_iters}; x rel diff "
              f"{rel(xd, x_s):.2e}")
        check(abs(itd - int(it_s)) <= 2 and rel(xd, x_s) <= 1e-5,
              "distributed CG differs from the single-device CG")
        check(abs(itd - cg_iters) <= 2,
              "distributed CG iterations differ from the fused CG's")
        xj_s, _, itj_s, _ = cg_full(A, b, tol=1e-6, maxiter=500, M=jac)
        check(abs(out["halo cg f32 jacobi"][1] - int(itj_s)) <= 2
              and rel(out["halo cg f32 jacobi"][0], xj_s) <= 1e-5,
              "distributed Jacobi-CG differs from the single-device one")
        W = csr_to_cwell(A_csr)
        xg_s, _, itg_s, _ = cg_full(W, b, tol=1e-6, maxiter=500)
        check(abs(out["general cg f32"][1] - int(itg_s)) <= 2
              and rel(out["general cg f32"][0], xg_s) <= 1e-5,
              "distributed CWELL CG differs from the single-device one")
        x64_s, _, it64_s, _ = cg_full(A64, b64, tol=1e-8)
        for label in ("halo cg f64", "general cg f64"):
            check(abs(out[label][1] - int(it64_s)) <= 2
                  and rel(out[label][0], x64_s) <= 1e-6,
                  f"{label} differs from the single-device f64 CG")
        Xb_s, _, itb_s, _ = block_cg(W, B, tol=1e-6, maxiter=500)
        print(f"  block cg: {out['general block cg f32'][1]} iterations, "
              f"single-device {int(itb_s)}; X rel diff "
              f"{rel(out['general block cg f32'][0], Xb_s):.2e}")
        check(abs(out["general block cg f32"][1] - int(itb_s)) <= 2
              and rel(out["general block cg f32"][0], Xb_s) <= 1e-4,
              "distributed block CG differs from the single-device one")
        xa_s, _, ita_s, _ = cg_full(A_amg, b_amg, tol=1e-6,
                                    M=amg_preconditioner(A_amg))
        print(f"  amg-pcg: {out['amg-pcg f32'][1]} iterations, "
              f"single-device {int(ita_s)}")
        check(abs(out["amg-pcg f32"][1] - int(ita_s)) <= 2
              and rel(out["amg-pcg f32"][0], xa_s) <= 1e-3,
              "distributed AMG-PCG differs from the single-device one")

        # -- kernels on the distributed routes against their plain versions
        A_sh, _, op = _shard_and_resolve(A, mesh, "halo")
        loc = LocalExtendedOperator(A_sh)
        xv = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)
        xe = loc.extend(xv)
        y_k, y_p = loc(xe), loc.apply_plain(xe)
        whole = cuda_spmv.ExtendedStencilOperator(A)
        err = rel_err(y_k, y_p)
        print(f"  kernel 1 extended on the rank's rows: rel err to plain "
              f"{err:.2e}; bit-equal to the single-device extended "
              f"operator: {bool(torch.equal(y_k, whole(whole.extend(xv))))}"
              f"; the halo SpMV equals it: "
              f"{bool(torch.equal(op(xv), loc.extract(y_k)))}")
        check(err <= 1e-5 and torch.equal(op(xv), loc.extract(y_k)),
              "the halo SpMV disagrees with kernel 1")
        W_sh, _, ag = _shard_and_resolve(A_csr, mesh, "allgather")
        H0 = HaloCWELL(W_sh.W, 0, 0, W_sh.shape, 0)
        y_h = make_cwell_halo_spmv(H0, mesh)(xv)
        y_ag = ag(xv)
        y_ref = ref.cwell_spmv(W_sh.W, xv)
        print(f"  CWELL halo route (empty plan) == all_gather route: "
              f"{bool(torch.equal(y_h, y_ag))}; rel err to the plain "
              f"SpMV {rel_err(y_ag, y_ref):.2e}")
        check(torch.equal(y_h, y_ag) and rel_err(y_ag, y_ref) <= 1e-5,
              "the CWELL routes disagree")

        # -- times: CUDA events, median and min-max of 5 ------------------
        def fmt(t):
            return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

        t_d = times(lambda: distributed_cg(A, b, mesh=mesh, mode="halo",
                                           tol=1e-6, maxiter=500), 1)
        t_s = times(lambda: cg_full(A, b, tol=1e-6, maxiter=500), 1)
        t_g = times(lambda: distributed_cg(A_csr, b, mesh=mesh, tol=1e-6,
                                           maxiter=500), 1)
        t_spmv = times(lambda: op(xv), 20)
        t_k = times(lambda: whole.apply_cuda(whole.extend(xv))
                    if dev.type == "cuda" else whole(whole.extend(xv)), 20)
        print(f"  time to tol 1e-6 at n={n}: distributed halo CG "
              f"{fmt(t_d)} ({itd} it, {t_d[0] / itd:.3f} ms/it); "
              f"single-device cg_full {fmt(t_s)} ({int(it_s)} it); "
              f"phase (4)'s fused CG {fmt(fused_ms)} ({cg_iters} it); "
              f"distributed CWELL CG {fmt(t_g)}")
        print(f"  one distributed halo SpMV {fmt(t_spmv)} "
              f"({A.nnz / (t_spmv[0] * 1e-3) / 1e9:.2f} Gnnz/s) against "
              f"extend + kernel 1 extended {fmt(t_k)}")

        # -- collectives per iteration (the recorder) ---------------------
        for label, pipeline in (("cg", False), ("cg_sr", True)):
            st = comm_model.measure_per_iteration(
                lambda k, p=pipeline: distributed_cg(
                    A, b, mesh=mesh, mode="halo", tol=0.0, maxiter=k,
                    pipeline=p))
            print(f"  collectives per {label} iteration: {st.summary()}")
            check(st.summary().get("all-reduce", {}).get("count")
                  == (2 if label == "cg" else 1),
                  f"{label}: unexpected all-reduce rounds per iteration")
            check("collective-permute" not in st.summary(),
                  "one rank exchanged halo bytes")
        del A, A_csr, A64, A64_csr, A_amg, B, W
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def kernel_profile(run, name: str):
    """One call of ``run`` under torch.profiler: (device kernels launched,
    launches of the kernels whose name holds ``name``, their summed device
    ms), or None when the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.key != "Command Buffer Full"]
    if not rows:
        return None

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    hit = [e for e in rows if name in e.key]
    return (sum(e.count for e in rows), sum(e.count for e in hit),
            sum(dev_us(e) for e in hit) / 1e3)


def ilu_phases(dev, b_main, *, counts, reset_counts, main_runs, times,
               cg_iters, jacobi_iters, fused_ms, nx=MAIN_NX,
               small_nx=F64_NX, grad_nx=32, cmp_nx=16, K=8):
    """Phase (27): ILU(0) (``precond/ilu.py``: host factor, level-scheduled
    substitutions). The set-up of poisson3d_27pt(nx) f32 timed in its host
    factor and its level packs; the main-path run: ``solve(M="ilu0")``
    with CG on cg_110M's system and b (every level sweep K4), BiCGStab on
    the convection-diffusion system at small_nx^3 (at nx^3 it took a
    second 160^3 set-up, ~35 s in all), float64 'auto' and 'full' at
    small_nx^3 (K4 inner sweeps, K5 sweeps), batched CG with B of K
    columns at small_nx^3 (K6/K7 sweeps) and a float64 CG gradient in b
    at grad_nx^3 (the CPU's own solve of it, the comparison, grows with
    the size; 32^3 keeps the phase short); then K4, K5 and K6/K7 against
    the plain compact product on those runs' level packs (the deepest and
    every 32nd), the card against the CPU
    at cmp_nx^3 (factor, apply, block apply) and grad_nx^3 (the
    gradient), one apply's time and launches at nx^3, the ILU-PCG times
    beside M None / Jacobi, a cuSPARSE float64 CSR matvec at nx^3
    (kernel 3's library yardstick) and the phase's peak memory.
    ``cg_iters`` / ``jacobi_iters``: phase (4)'s fused CG iterations;
    ``fused_ms``: its (median, min, max) time with M None."""
    import torch

    from tpu_sparse_torch import precond as tpre
    from tpu_sparse_torch.api.solver import _get_default_solver
    from tpu_sparse_torch.kernels import cuda_cwell
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.precond.ilu import factor_host
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr

    import tpu_sparse_torch

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED + 27)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fmt(t):
        return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

    phase(f"(27) main path: ILU(0) through solve(M='ilu0'): set-up and CG "
          f"on poisson3d_27pt({nx}) f32 (cg_110M's b), BiCGStab on "
          f"convection_diffusion_3d_27pt({small_nx}), f64 'auto' / 'full' "
          f"and B of {K} columns at {small_nx}^3, a gradient at "
          f"{grad_nx}^3; card against CPU at {cmp_nx}^3")
    A = gen.poisson3d_27pt(nx, device=dev)
    b = b_main
    n = A.shape[0]
    A64 = gen.poisson3d_27pt(small_nx, dtype=np.float64, device=dev)
    n64 = A64.shape[0]
    A_cd = gen.convection_diffusion_3d_27pt(small_nx, device=dev)
    b_cd = A_cd @ torch.from_numpy(rng.standard_normal(n64).astype(
        np.float32)).to(dev)
    b64 = A64 @ torch.from_numpy(rng.standard_normal(n64)).to(dev)
    A32s = gen.poisson3d_27pt(small_nx, device=dev)
    B = torch.from_numpy(rng.standard_normal((n64, K)).astype(
        np.float32)).to(dev)
    A_g = gen.poisson3d_27pt(grad_nx, dtype=np.float64, device=dev)
    b_g = torch.from_numpy(rng.standard_normal(A_g.shape[0])).to(dev)
    w_g = torch.from_numpy(rng.standard_normal(A_g.shape[0])).to(dev)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def timed(call):
        """(call's result, its ms by CUDA events; the host clock on the
        CPU)."""
        if not cuda:
            t0 = time.perf_counter()
            return call(), (time.perf_counter() - t0) * 1e3
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = call()
        e1.record()
        e1.synchronize()
        return r, e0.elapsed_time(e1)

    # -- set-up at nx^3: the host factor alone, then the router's build of
    # the preconditioner (the factor again and the level packs on the
    # card), cached for the solves below; the first apply builds each
    # pack's compact plan
    solver = _get_default_solver()
    t0 = time.perf_counter()
    _, _, _, levels = factor_host(A)
    t_factor = time.perf_counter() - t0
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    M = solver._precond_M(A, "ilu0")
    sync()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    M(v)
    sync()
    t_plans = time.perf_counter() - t0
    n_packs = sum(len(sw.operators()) for sw in (M.fwd, M.bwd))
    print(f"  set-up of poisson3d_27pt({nx}): factor + level packs "
          f"{t_build:.2f} s, first apply (each pack's compact plan) "
          f"{t_plans:.2f} s; levels {M.levels}, {n_packs} packs", flush=True)
    check(M.levels == (7 * (nx - 1) + 1,) * 2,
          f"ILU(0) levels {M.levels}, not the stencil's wavefronts")
    packs = [N for sw in (M.fwd, M.bwd) for N in sw.operators()]
    print(f"  poisson3d_27pt({nx}): host factor alone {t_factor:.2f} s "
          f"(levels {levels}), so its packs take the rest", flush=True)
    solver._precond_M(A_cd, "ilu0")(b_cd)  # BiCGStab's set-up, not timed
    sync()

    # -- the main-path run: every launch from here to the read counts
    bicg_label = f"bicgstab f32 ilu0 (convection-diffusion {small_nx}^3)"
    reset_counts()
    out = {}
    for label, call in (
            ("cg f32 ilu0", lambda: tpu_sparse_torch.solve(
                A, b, method="cg", M="ilu0", tol=1e-6, maxiter=500)),
            (bicg_label, lambda: tpu_sparse_torch.solve(
                A_cd, b_cd, method="bicgstab", M="ilu0", tol=1e-6,
                maxiter=500)),
            (f"cg f64 auto ilu0 {small_nx}^3", lambda: tpu_sparse_torch.solve(
                A64, b64, method="cg", M="ilu0", tol=1e-8)),
            (f"cg f64 full ilu0 {small_nx}^3", lambda: tpu_sparse_torch.solve(
                A64, b64, method="cg", M="ilu0", tol=1e-8,
                precision="full")),
            (f"cg batched f32 ilu0 B {K} {small_nx}^3",
             lambda: tpu_sparse_torch.solve(
                 A32s, B, method="cg", M="ilu0", tol=1e-6, maxiter=500,
                 multi_rhs="batch"))):
        before = counts()
        (x, res), ms = timed(call)
        grew = {k: val - before[k] for k, val in counts().items()
                if val != before[k]}
        out[label] = (res.iterations, ms)
        print(f"  {label}: {res}; {ms:.2f} ms (first call); launches "
              f"{grew}", flush=True)
        check(res.converged, f"{label} did not converge")
        check(res.residual <= (1e-5 if "f32" in label else 1e-8),
              f"{label}: true relative residual {res.residual}")
    bg = b_g.clone().requires_grad_()
    xg, resg = tpu_sparse_torch.solve(A_g, bg, method="cg", M="ilu0",
                                      tol=1e-8, precision="full")
    (xg * w_g).sum().backward()
    sync()
    check(resg.converged, "the differentiated ILU-CG did not converge")
    main_runs["phase (27)"] = counts()
    print(f"  main-path launches in phase (27): {main_runs['phase (27)']}")
    for k in ("cwell_spmv_f32", "cwell_spmv_f64", "cwell_spmm_f32"):
        check(main_runs["phase (27)"][k] > 0,
              f"phase (27): {k} did not carry the ILU(0) sweeps")
    if cuda:
        print(f"  peak device memory over the phase's set-up and solves: "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

    # -- the sweeps' kernels against the plain compact product at their
    # main-path shapes (not counted): the deepest level pack and every
    # 32nd of the 160^3 f32 factor (K4), the 64^3 f64 one (K5) and the
    # 64^3 f32 one with B of K columns (K6/K7)
    kspmv = cuda_cwell.cwell_spmv_cuda if cuda else cuda_cwell.cwell_spmv
    kspmm = cuda_cwell.cwell_spmm_cuda if cuda else cuda_cwell.cwell_spmm
    for label, MM, k, tol in ((f"f32 {nx}^3", M, None, 1e-5),
                              (f"f64 {small_nx}^3",
                               solver._precond_M(A64, "ilu0"), None, 1e-12),
                              (f"f32 {small_nx}^3, B of {K} columns",
                               solver._precond_M(A32s, "ilu0"), K, 1e-5)):
        ps = sorted((N for sw in (MM.fwd, MM.bwd) for N in sw.operators()),
                    key=lambda N: -cwell_compact.compact(N)[0].depth)
        sample = ps[:1] + ps[1::32]
        m = ps[0].shape[1]
        shape = (m,) if k is None else (m, k)
        y = torch.from_numpy(rng.standard_normal(shape)).to(dev, MM.dtype)
        err = 0.0
        for N in sample:
            pl, cv = cwell_compact.compact(N)
            if k is None:
                err = max(err, rel_err(kspmv(N, y),
                                       ref.cwell_compact_spmv(pl, cv, y)))
            else:
                err = max(err, rel_err(kspmm(N, y),
                                       ref.cwell_compact_spmm(pl, cv, y)))
        kern = ("K4" if MM.dtype == torch.float32 else "K5") if k is None \
            else "K6/K7"
        print(f"  level packs {label}: {len(sample)} of {len(ps)} (deepest "
              f"plan {cwell_compact.compact(ps[0])[0].depth} slot rows): "
              f"{kern} against the plain compact product {err:.2e}",
              flush=True)
        check(err <= tol, f"ILU(0) level packs {label}: {kern} differs from "
              "its plain version")

    # -- the card against the CPU (not counted) ---------------------------
    t0 = time.perf_counter()
    for make in (gen.poisson3d_27pt, gen.convection_diffusion_3d_27pt):
        Ac = make(cmp_nx, dtype=np.float64, device="cpu")
        (Lc, Uc), (Lg, Ug) = tpre.ilu0_factor(Ac), tpre.ilu0_factor(
            Ac.to(dev))
        same = (torch.equal(Lg.data.cpu(), Lc.data)
                and torch.equal(Ug.data.cpu(), Uc.data))
        Mc, Mg = tpre.ilu0_preconditioner(Ac), tpre.ilu0_preconditioner(
            Ac.to(dev))
        vc = torch.from_numpy(rng.standard_normal(Ac.shape[0]))
        Vc = torch.from_numpy(rng.standard_normal((Ac.shape[0], K)))
        e1 = rel_err(Mg(vc.to(dev)).cpu(), Mc(vc))
        ek = rel_err(Mg.matmat(Vc.to(dev)).cpu(), Mc.matmat(Vc))
        print(f"  {make.__name__}({cmp_nx}) f64: factor card == CPU {same}; "
              f"apply rel err {e1:.2e}, (n, {K}) block {ek:.2e}; levels "
              f"{Mg.levels}")
        check(same and e1 <= 1e-12 and ek <= 1e-12,
              f"ILU(0) on the card differs from the CPU on {make.__name__}")
    bc = b_g.cpu().requires_grad_()
    xc, resc = tpu_sparse_torch.solve(A_g.to("cpu"), bc, method="cg",
                                      M="ilu0", tol=1e-8, precision="full")
    (xc * w_g.cpu()).sum().backward()
    eg = rel_err(bg.grad.cpu(), bc.grad)
    print(f"  cg gradient in b at {grad_nx}^3 f64: {resg.iterations} it "
          f"card, {resc.iterations} CPU; rel diff {eg:.2e} (card against "
          f"CPU checks {time.perf_counter() - t0:.1f} s)")
    check(eg <= 1e-6, "the ILU-CG gradient differs from the CPU's")

    # -- one apply at nx^3 ----------------------------------------------------
    before = counts()
    M(v)
    sync()
    per_apply = {k: val - before[k] for k, val in counts().items()
                 if val != before[k]}
    t_apply = times(lambda: M(v), 1, reps=5, warmup=1)
    spmv_bytes = 0
    for N in packs:
        pl, cv = cwell_compact.compact(N)
        # the plan's values and indices, block offsets and window rows,
        # one x value per slot and the level's y rows
        spmv_bytes += (pl.slots * (cv.element_size() + pl.idx.element_size()
                                   + cv.element_size())
                       + pl.boff.numel() * 8 + pl.srow.numel() * 4
                       + N.shape[0] * cv.element_size())
    print(f"  one apply at n={n}: {fmt(t_apply)} (CUDA events), launches "
          f"counted {per_apply}; the K4 packs' bytes {spmv_bytes / 1e6:.1f}"
          f" MB, bound {spmv_bytes / 3.35e9:.4f} ms", flush=True)
    prof = kernel_profile(lambda: M(v), "cwell_spmv") if cuda else None
    if prof is None:
        print("  apply under torch.profiler: not measured (no device time)")
    else:
        k_all, k4_n, k4_ms = prof
        print(f"  apply under torch.profiler: {k_all} device kernels, K4 "
              f"{k4_n} events of the counter's "
              f"{per_apply.get('cwell_spmv_f32', 0)} launches, {k4_ms:.2f} "
              f"ms summed over those events ("
              f"{k4_ms / max(k4_n, 1) * 1e3:.1f} us an event against "
              f"{spmv_bytes / max(len(packs), 1) / 3.35e6:.2f} us of its "
              f"bytes at 3.35 TB/s)", flush=True)

    # -- ILU-PCG times beside M None / Jacobi: CG's main-path run and two
    # more, by CUDA events; BiCGStab's main-path run
    t_cg = [out["cg f32 ilu0"][1]] + [timed(lambda: tpu_sparse_torch.solve(
        A, b, method="cg", M="ilu0", tol=1e-6, maxiter=500))[1]
        for _ in range(2)]
    it_cg = out["cg f32 ilu0"][0]
    print(f"  time to tol 1e-6, cg f32 ilu0: "
          f"{fmt((float(np.median(t_cg)), min(t_cg), max(t_cg)))} (median "
          f"and min-max of 3), {it_cg} it; {bicg_label}: "
          f"{out[bicg_label][1]:.2f} ms, {out[bicg_label][0]} it",
          flush=True)
    print(f"  yardsticks (phase (4)): cg M=None {cg_iters} it "
          f"{fmt(fused_ms)} (fused); M=jacobi {jacobi_iters} it")
    check(it_cg < cg_iters, "ILU(0) did not lower CG's iterations")

    # -- kernel 3's library yardstick at nx^3 ---------------------------------
    del M, packs
    solver._m_cache._store.clear()
    if cuda:
        torch.cuda.empty_cache()
    A64L = gen.poisson3d_27pt(nx, dtype=np.float64, device=dev)
    C = to_csr(A64L)
    lib = torch.sparse_csr_tensor(C.indptr, C.indices, C.data, size=C.shape)
    x64 = torch.from_numpy(rng.standard_normal(n)).to(dev)
    e_lib = rel_err(torch.mv(lib, x64), A64L @ x64)
    t_lib = times(lambda: torch.mv(lib, x64), 10)
    print(f"  cuSPARSE f64 CSR matvec of poisson3d_27pt({nx}, float64): "
          f"{fmt(t_lib)} (rel err to kernel 3 plain {e_lib:.1e})")
    check(e_lib <= 1e-12, "the f64 CSR yardstick computes another function")
    del lib, C, A64L
    if cuda:
        torch.cuda.empty_cache()
    print(f"  phase (27) wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def unitary_similarity(A, D):
    """D^H A D for a DIA A and D = diag(d), |d| = 1 (complex128 on A's
    device): the complex dtype of A's precision. A unitary similarity
    leaves every Krylov iterate of A x = b unchanged (as D^H x for the
    right-hand side D^H b), so a complex solve is held to the real one's
    iterations."""
    import torch

    dt = (torch.complex64 if A.data.dtype == torch.float32
          else torch.complex128)
    n = A.shape[0]
    data = A.data.to(dt)
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, n - o)
        if i1 > i0:
            data[d, i0:i1] *= (D[i0:i1].conj() * D[i0 + o:i1 + o]).to(dt)
    return A.with_data(data)


def complex_phases(dev, b_main, *, note, counts, reset_counts, main_runs,
                   times, cg_iters, nonsym_iters, nx=MAIN_NX,
                   small_nx=F64_NX, grad_nx=32, direct_nx=128, bell_nx=40,
                   K=8):
    """Phase (28): native complex. The main-path run: CG on A_h = D^H L D
    (L = poisson3d_27pt(nx), D = diag(exp(i theta)), theta from
    default_rng(0); b_h = D^H b with cg_110M's b) with M None and Jacobi,
    BiCGStab and GMRES(20) on C_h = D^H C D (C the convection-diffusion
    system, b phase (8)'s), GMRES(20) on (1 + 0.2i) C, CG on the CWELL of
    A_h (K4 c64), batched CG with B of K complex64 columns on it (K6/K7
    c64), batched CG on the kron BELL made Hermitian by a unitary
    similarity at k = K (K8 c64) and k = 4 in complex128 (K8 c128); at
    small_nx^3 in complex128 'full' with Jacobi on DIA (kernel 1 c128) and
    CWELL (K5 c128), 'mixed' (complex64 inner sweeps), batched on the
    CWELL at k = 4 (K6/K7 c128) and M='ilu0'; a CG gradient at
    grad_nx^3; the supernodal direct solve of
    poisson2d(direct_nx) (1 + 0.3i) + 0.1 triu; a real L with the complex
    b_h (one cast of L a solve, none again). The counts are read after
    that run; then each complex kernel against its plain version at the
    160^3 shapes (complex64 within 1e-5 of max|y|, complex128 within
    1e-12), timed (CUDA events, median of 5) beside its bound, its plain
    version and a cuSPARSE call, the card's ILU(0) apply and gradient
    against the CPU's, and the solves (median of 3) beside the real
    solves of the same systems. ``cg_iters``: phase (4)'s iterations by
    M; ``nonsym_iters``: phase (8)'s by method (BiCGStab is held to the
    real system's ``bicgstab_full`` instead: phase (8) ran K10, which
    stops by blocks of 12)."""
    import scipy.sparse as sp
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch import kernels as tk
    from tpu_sparse_torch import precond as tpre
    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell, cuda_spmv
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.kernels.spmm_probe import (bell_bytes, cwell_bytes,
                                                     kron_bell)
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import (csr_from_arrays, to_csr,
                                                 to_scipy_csr)
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    c64, c128 = torch.complex64, torch.complex128

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fmt(t):
        return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"

    def crandn(rng, shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape)).to(
                                    dev, dtype)

    def true_rel(apply, b, x):
        """Largest ||b - A x|| / ||b|| over the columns, by the plain
        product (no kernel launch)."""
        with torch.no_grad():
            r = torch.linalg.vector_norm(b - apply(x), dim=0)
            return float((r / torch.linalg.vector_norm(b, dim=0)).max())

    phase(f"(28) main path: native complex: CG / BiCGStab / GMRES(20) on "
          f"D^H A D of the {nx}^3 systems (complex64), their CWELL and the "
          f"kron BELL made Hermitian, with B of {K} columns; complex128 'full' / "
          f"'mixed' / ILU(0) at {small_nx}^3, a gradient at {grad_nx}^3, "
          f"the supernodal LU of poisson2d({direct_nx}) (1 + 0.3i) + 0.1 "
          f"triu; a real L with a complex b")
    rng = np.random.default_rng(SEED)
    L = gen.poisson3d_27pt(nx, device=dev)
    n = L.shape[0]
    D = torch.from_numpy(np.exp(1j * rng.uniform(0, 2 * np.pi, n))).to(dev)
    A_h = unitary_similarity(L, D)
    C = gen.convection_diffusion_3d_27pt(nx, device=dev)
    C_h = unitary_similarity(C, D)
    C_s = C.with_data(C.data.to(c64) * (1 + 0.2j))
    b_h = (D.conj() * b_main).to(c64)
    x8 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        n).astype(np.float32)).to(dev)
    b_cd = C @ x8  # phase (8)'s b (set-up: not counted)
    b_ch = (D.conj() * b_cd).to(c64)
    # the yardstick of the complex BiCGStab: the same loop on the real
    # system (phase (8)'s solve ran K10, whose block-of-12 stopping rule
    # gives another count)
    from tpu_sparse_torch.solvers import bicgstab_full

    bicg_real = int(bicgstab_full(C, b_cd, tol=1e-6, maxiter=500)[2])
    t0 = time.perf_counter()
    W_h = csr_to_cwell(to_csr(A_h))
    sync()
    t_pack = time.perf_counter() - t0
    Bk = crandn(np.random.default_rng(SEED), (n, K), c64)
    bell, bell_csr, _ = kron_bell(dev, bell_nx, np.random.default_rng(SEED))
    # the kron BELL made Hermitian by a unitary similarity: CG reads p^H A p
    # as real, so (1 + 0.2i) K (complex symmetric, not Hermitian) is no CG
    # system in either package
    Db = torch.from_numpy(np.exp(1j * rng.uniform(
        0, 2 * np.pi, bell.shape[0]))).to(dev)
    bs = bell.blocksize
    ii = torch.arange(bs, device=dev)
    rows = torch.arange(bell.n_block_rows, device=dev)[:, None] * bs + ii
    cols = bell.indices.long()[:, :, None] * bs + ii
    bell_z = bell.with_data(
        bell.blocks * Db[rows].conj()[:, None, :, None]
        * Db[cols.clamp_max(bell.shape[1] - 1)][:, :, None, :])
    bell_c = bell_z.with_data(bell_z.blocks.to(c64))
    bell_csr = bell_csr.with_data(
        bell_csr.data * Db[bell_csr.row_ids().long()].conj()
        * Db[bell_csr.indices.long()])
    del bell, rows, cols
    Bb = crandn(rng, (bell_c.shape[0], K), c64)
    Bb128 = Bb[:, :4].to(c128)
    L64 = gen.poisson3d_27pt(small_nx, dtype=np.float64, device=dev)
    n64 = L64.shape[0]
    A64 = unitary_similarity(L64, torch.from_numpy(np.exp(
        1j * rng.uniform(0, 2 * np.pi, n64))).to(dev))
    b64 = ref.dia_spmv(A64, crandn(rng, n64, c128))
    W64 = csr_to_cwell(to_csr(A64))
    B64 = crandn(rng, (n64, 4), c128)
    Lg = gen.poisson3d_27pt(grad_nx, dtype=np.float64, device=dev)
    Ag = unitary_similarity(Lg, torch.from_numpy(np.exp(
        1j * rng.uniform(0, 2 * np.pi, Lg.shape[0]))).to(dev))
    bg0 = crandn(rng, Ag.shape[0], c128)
    wg = crandn(rng, Ag.shape[0], c128)
    P = to_scipy_csr(gen.poisson2d(direct_nx, dtype=np.float64,
                                   device="cpu"))
    S_dir = (P * (1 + 0.3j) + 0.1 * sp.triu(P, k=1)).tocsr()
    S_dir.sort_indices()
    A_dir = csr_from_arrays(S_dir.data, S_dir.indices, S_dir.indptr,
                            S_dir.shape, device=dev)
    b_dir = torch.from_numpy(S_dir @ (
        rng.standard_normal(S_dir.shape[0])
        + 1j * rng.standard_normal(S_dir.shape[0]))).to(dev)
    sync()
    print(f"  n={n}: A_h, C_h complex64 DIA {A_h.data.numel() * 8 / 1e6:.1f}"
          f" MB each; CWELL of A_h packed on the card in {t_pack:.2f} s "
          f"(S={W_h.srow.shape[1]}); kron BELL n={bell_c.shape[0]}, "
          f"{bell_c.blocks.numel()} stored entries; {small_nx}^3 n={n64}; "
          f"direct n={S_dir.shape[0]}, nnz {S_dir.nnz}", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- the main-path run: every launch from here to the read counts
    solver = tpu_sparse_torch.SparseSolver()
    solve = solver.solve
    reset_counts()
    out = {}

    def run(label, call, rel, bound):
        before = counts()
        t0 = time.perf_counter()
        x, res = call()
        sync()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        rr = rel(x)
        out[label] = (res.iterations, x)
        print(f"  {label}: {res}; true rel res {rr:.2e}; first call "
              f"{wall * 1e3:.1f} ms wall; launches {grew}", flush=True)
        check(res.converged, f"{label} did not converge")
        check(rr <= bound, f"{label}: true relative residual {rr}")
        return res

    def on(A):
        return lambda x: ref.dia_spmv(A, x) if x.dim() == 1 \
            else ref.dia_spmm(A, x)

    kw6 = dict(tol=1e-6, maxiter=500)
    r = run("cg c64 M=None", lambda: solve(A_h, b_h, method="cg", **kw6),
            lambda x: true_rel(on(A_h), b_h, x), 1e-5)
    check(abs(r.iterations - cg_iters[None]) <= 3,
          f"complex CG took {r.iterations} it, phase (4) {cg_iters[None]}")
    r = run("cg c64 M=jacobi", lambda: solve(A_h, b_h, method="cg",
                                             M="jacobi", **kw6),
            lambda x: true_rel(on(A_h), b_h, x), 1e-5)
    check(abs(r.iterations - cg_iters["jacobi"]) <= 3,
          f"complex Jacobi CG took {r.iterations} it, phase (4) "
          f"{cg_iters['jacobi']}")
    yard = {"bicgstab": bicg_real, "gmres": nonsym_iters["gmres"]}
    for method, kw in (("bicgstab", {}), ("gmres", dict(restart=20))):
        r = run(f"{method} c64 on C_h",
                lambda: solve(C_h, b_ch, method=method, **kw, **kw6),
                lambda x: true_rel(on(C_h), b_ch, x), 1e-5)
        print(f"    the real system's {method}: {yard[method]} by the same "
              f"loop; phase (8) {nonsym_iters[method]}", flush=True)
        check(abs(r.iterations - yard[method]) <= 2,
              f"complex {method} took {r.iterations}, the real system "
              f"{yard[method]}")
    run("gmres c64 on (1 + 0.2i) C",
        lambda: solve(C_s, b_ch, method="gmres", restart=20, **kw6),
        lambda x: true_rel(on(C_s), b_ch, x), 1e-5)
    r = run("cg c64 on the CWELL of A_h",
            lambda: solve(W_h, b_h, method="cg", **kw6),
            lambda x: true_rel(on(A_h), b_h, x), 1e-5)
    check(abs(r.iterations - out["cg c64 M=None"][0]) <= 2,
          "complex CG on the CWELL strays from the DIA solve")
    run(f"cg batched c64 B {K} on the CWELL",
        lambda: solve(W_h, Bk, method="cg", multi_rhs="batch", **kw6),
        lambda X: true_rel(on(A_h), Bk, X), 1e-5)
    run(f"cg batched c64 B {K} on the kron BELL",
        lambda: solve(bell_c, Bb, method="cg", multi_rhs="batch", **kw6),
        lambda X: true_rel(lambda Y: ref.bell_spmm(bell_c, Y), Bb, X), 1e-5)
    run("cg batched c128 B 4 on the kron BELL",
        lambda: solve(bell_z, Bb128, method="cg", multi_rhs="batch",
                      tol=1e-10, maxiter=500),
        lambda X: true_rel(lambda Y: ref.bell_spmm(bell_z, Y), Bb128, X),
        1e-10)
    kw10 = dict(tol=1e-10, maxiter=2000)
    for label, op in (("DIA", A64), ("CWELL", W64)):
        run(f"cg c128 full jacobi {small_nx}^3 {label}",
            lambda: solve(op, b64, method="cg", M="jacobi",
                          precision="full", **kw10),
            lambda x: true_rel(on(A64), b64, x), 1e-10)
    run(f"cg c128 mixed {small_nx}^3 (complex64 sweeps)",
        lambda: solve(A64, b64, method="cg", precision="mixed", **kw10),
        lambda x: true_rel(on(A64), b64, x), 1e-10)
    run(f"cg batched c128 B 4 {small_nx}^3 CWELL",
        lambda: solve(W64, B64, method="cg", multi_rhs="batch",
                      precision="full", **kw10),
        lambda X: true_rel(on(A64), B64, X), 1e-10)
    run(f"cg c128 ilu0 {small_nx}^3",
        lambda: solve(A64, b64, method="cg", M="ilu0", precision="full",
                      **kw10),
        lambda x: true_rel(on(A64), b64, x), 1e-10)

    def grad_run(where):
        vals = Ag.data.to(where, copy=True).requires_grad_()
        bg = bg0.to(where, copy=True).requires_grad_()
        x, res = solve(Ag.to(where).with_data(vals), bg, method="cg",
                       tol=1e-12, maxiter=2000, precision="full")
        ((wg.to(where) @ x).abs() ** 2).backward()
        check(res.converged, f"the gradient's solve on {where} did not "
              "converge")
        return vals.grad.cpu(), bg.grad.cpu(), res.iterations

    grads_card = grad_run(dev)
    run(f"direct c128 poisson2d({direct_nx}) (1 + 0.3i) + 0.1 triu",
        lambda: solve(A_dir, b_dir, method="direct"),
        lambda x: float(np.linalg.norm(b_dir.cpu().numpy()
                                       - S_dir @ x.cpu().numpy())
                        / np.linalg.norm(b_dir.cpu().numpy())), 1e-6)
    rel_dir = float(np.linalg.norm(b_dir.cpu().numpy() - S_dir @ out[
        f"direct c128 poisson2d({direct_nx}) (1 + 0.3i) + 0.1 triu"][1]
        .cpu().numpy()) / np.linalg.norm(b_dir.cpu().numpy()))
    rel_splu = superlu_reference_residual(S_dir, b_dir.cpu().numpy())
    print(f"  direct: true rel res {rel_dir:.3e}; SuperLU's own complex128 "
          f"solve {rel_splu:.3e} (the bound: 10x)", flush=True)
    check(rel_dir <= 10 * max(rel_splu, 1e-16),
          "the complex supernodal solve misses SuperLU's residual by 10x")
    casts0 = tk.CAST_COUNTS["values_casts"]
    x_r, r_r = solve(L, b_h, method="cg", **kw6)
    casts1 = tk.CAST_COUNTS["values_casts"]
    x_r2, _ = solve(L, b_h, method="cg", **kw6)
    casts2 = tk.CAST_COUNTS["values_casts"]
    sync()
    main_runs["phase (28)"] = counts()
    print(f"  real L (float32) with the complex b_h: {r_r}; casts of L "
          f"{casts1 - casts0} in the first solve, {casts2 - casts1} in the "
          f"second", flush=True)
    print(f"  main-path launches in phase (28): {main_runs['phase (28)']}",
          flush=True)
    keys = ("dia_spmv_c64", "dia_spmv_c128", "cwell_spmv_c64",
            "cwell_spmv_c128", "cwell_spmm_c64", "cwell_spmm_c128",
            "bell_spmm_c64", "bell_spmm_c128")
    for k in keys:
        check(main_runs["phase (28)"][k] > 0,
              f"phase (28): {k} was not launched on the main path")
    check(r_r.converged and casts1 - casts0 == 1 and casts2 == casts1,
          "a real L with a complex b is not cast exactly once")
    x_hand, _ = tpu_sparse_torch.SparseSolver().solve(
        L.with_data(L.data.to(c64)), b_h, method="cg", **kw6)
    check(torch.equal(x_r, x_hand) and torch.equal(x_r, x_r2),
          "the real-L solve differs from the solve with L cast by hand")
    print("  x of the real-L solve == x with L cast by hand, bit for bit",
          flush=True)
    if cuda:
        print(f"  peak device memory over the phase's solves: "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

    # -- the card against the CPU (not counted) ----------------------------
    t0 = time.perf_counter()
    Mg = solver._precond_M(A64, "ilu0")
    Mc = tpre.ilu0_preconditioner(A64.to("cpu"))
    v = crandn(rng, n64, c128)
    e_ilu = rel_err(Mg(v).cpu(), Mc(v.cpu()))
    grads_cpu = grad_run("cpu")
    e_gv = rel_err(grads_card[0], grads_cpu[0])
    e_gb = rel_err(grads_card[1], grads_cpu[1])
    print(f"  ILU(0) apply c128 {small_nx}^3 card against CPU: rel err "
          f"{e_ilu:.2e}; CG gradient {grad_nx}^3 c128 card ({grads_card[2]}"
          f" it) against CPU ({grads_cpu[2]} it): values {e_gv:.2e}, b "
          f"{e_gb:.2e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(e_ilu <= 1e-12, "the complex ILU(0) apply differs from the CPU's")
    check(e_gv <= 1e-10 and e_gb <= 1e-10,
          "the complex gradient on the card differs from the CPU's")
    del Mg, Mc, grads_card, grads_cpu
    solver._m_cache._store.clear()

    # -- each complex kernel against its plain version at the 160^3
    # shapes, and its time beside its bound, plain version and cuSPARSE
    A_z = A_h.with_data(A_h.data.to(c128))
    W_z = W_h.with_data(W_h.vals.to(c128))
    csr_h = to_csr(A_h)
    kern_rng = np.random.default_rng(SEED + 28)

    def library(csr, dt):
        return torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                       csr.data.to(dt), size=csr.shape)

    def kernel_row(key, kernel, plain, lib_call, nbytes, flops, dt):
        size = torch.tensor([], dtype=dt).element_size()
        tol = 1e-5 if dt == c64 else 1e-12
        y1, y0 = kernel(), plain()
        err = float((y1 - y0).abs().max())
        scale = float(y0.abs().max())
        check(err <= tol * scale,
              f"{key} disagrees with its plain version: {err} of {scale}")
        del y1, y0
        t_k = times(kernel, 10)
        t_p = times(plain, 1)
        lib_ms, lib_note = None, ""
        try:
            e_lib = rel_err(lib_call(), plain())
            check(e_lib <= tol, f"the cuSPARSE yardstick of {key} "
                  "computes another function")
            t_l = times(lib_call, 10)
            lib_ms = t_l[0]
            lib_note = f"cuSPARSE {fmt(t_l)} (rel err {e_lib:.1e})"
        except RuntimeError as exc:
            lib_note = f"cuSPARSE none ({str(exc).splitlines()[0][:120]})"
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = flops / (67e12 if dt == c64 else 34e12) * 1e3
        bound = max(t_bytes, t_ops)
        note(key, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
             library_ms=lib_ms, bound_ms=bound,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"  {key}: kernel {fmt(t_k)}; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {bound / t_k[0]:.2f} of it); plain "
              f"{fmt(t_p)}; {lib_note}; max abs err {err:.2e} (max|y| "
              f"{scale:.2e})", flush=True)

    for key, A_, dt in (("dia_spmv_c64", A_h, c64),
                        ("dia_spmv_c128", A_z, c128)):
        xk = crandn(kern_rng, n, dt)
        lib = library(csr_h, dt)
        size = torch.tensor([], dtype=dt).element_size()
        kernel_row(key, lambda: cuda_spmv.dia_spmv_cuda(A_, xk)
                   if cuda else cuda_spmv.dia_spmv(A_, xk),
                   lambda: ref.dia_spmv(A_, xk), lambda: torch.mv(lib, xk),
                   A_.data.numel() * size + 2 * n * size, 8 * L.nnz, dt)
        if cuda:
            same = same_bits(cuda_spmv.dia_spmv_cuda(A_, xk),
                             cuda_spmv.dia_spmv_v1_cuda(A_, xk))
            print(f"  {key}: == the first design (v1) bit for bit: {same}")
            check(same, f"{key} differs from v1")
        del lib
    for key, W_, dt in (("cwell_spmv_c64", W_h, c64),
                        ("cwell_spmv_c128", W_z, c128)):
        xk = crandn(kern_rng, n, dt)
        plan, cvals = cwell_compact.compact(W_)
        lib = library(csr_h, dt)
        size = torch.tensor([], dtype=dt).element_size()
        nb, S = W_.srow.shape
        nbytes = (plan.slots * (size + plan.idx.element_size())
                  + plan.boff.numel() * 8 + nb * S * 4 + 2 * n * size)
        kernel_row(key, lambda: cuda_cwell.cwell_spmv_cuda(W_, xk)
                   if cuda else cuda_cwell.cwell_spmv(W_, xk),
                   lambda: ref.cwell_compact_spmv(plan, cvals, xk),
                   lambda: torch.mv(lib, xk), nbytes, 8 * W_.nnz, dt)
        del lib, plan, cvals
    for key, W_, dt, k in (("cwell_spmm_c64", W_h, c64, K),
                           ("cwell_spmm_c128", W_z, c128, 4)):
        Bx = crandn(kern_rng, (n, k), dt)
        plan, cvals = cwell_compact.compact(W_)
        lib = library(csr_h, dt)
        size = torch.tensor([], dtype=dt).element_size()
        kernel_row(key, lambda: cuda_cwell.cwell_spmm_cuda(W_, Bx)
                   if cuda else cuda_cwell.cwell_spmm(W_, Bx),
                   lambda: ref.cwell_compact_spmm(plan, cvals, Bx),
                   lambda: torch.sparse.mm(lib, Bx),
                   cwell_bytes(plan, W_, size, k)[0], 8 * W_.nnz * k, dt)
        Y = (cuda_cwell.cwell_spmm_cuda if cuda else cuda_cwell.cwell_spmm)(
            W_, Bx)
        spmv = cuda_cwell.cwell_spmv_cuda if cuda else cuda_cwell.cwell_spmv
        same = all(torch.equal(Y[:, j], spmv(W_, Bx[:, j].contiguous()))
                   for j in range(k))
        print(f"  {key}: every column == K4/K5 bit for bit: {same}")
        if cuda:
            check(same, f"{key}: a column differs from K4/K5")
        del lib, plan, cvals, Bx, Y
    for key, bl, dt, k in (("bell_spmm_c64", bell_c, c64, K),
                           ("bell_spmm_c128", bell_z, c128, 4)):
        Bx = crandn(kern_rng, (bl.shape[1], k), dt)
        lib = library(bell_csr, dt)
        size = torch.tensor([], dtype=dt).element_size()
        kernel_row(key, lambda: cuda_bell.bell_spmm_cuda(bl, Bx)
                   if cuda else cuda_bell.bell_spmm(bl, Bx),
                   lambda: ref.bell_spmm(bl, Bx),
                   lambda: torch.sparse.mm(lib, Bx),
                   bell_bytes(bl, size, k), 8 * bl.blocks.numel() * k, dt)
        del lib, Bx
    del A_z, W_z, csr_h

    # -- solves (median of 3) beside the real solves of the same systems
    rows = [("cg M=None", lambda: solve(A_h, b_h, method="cg", **kw6),
             lambda: solve(L, b_main, method="cg", **kw6)),
            ("cg M=jacobi", lambda: solve(A_h, b_h, method="cg",
                                          M="jacobi", **kw6),
             lambda: solve(L, b_main, method="cg", M="jacobi", **kw6)),
            ("bicgstab", lambda: solve(C_h, b_ch, method="bicgstab", **kw6),
             lambda: solve(C, b_cd, method="bicgstab", **kw6)),
            ("gmres(20)", lambda: solve(C_h, b_ch, method="gmres",
                                        restart=20, **kw6),
             lambda: solve(C, b_cd, method="gmres", restart=20, **kw6)),
            ("cg on the CWELL", lambda: solve(W_h, b_h, method="cg", **kw6),
             None)]
    for label, cplx, real in rows:
        its = {}

        def timed(call, tag):
            def fn():
                its[tag] = call()[1].iterations
            return times(fn, 1, reps=3, warmup=1)

        t_c = timed(cplx, "c")
        line = f"  solve {label:16s} complex64 {fmt(t_c)} {its['c']} it"
        if real is not None:
            t_r = timed(real, "r")
            line += (f";   the real system (float32, its own route) "
                     f"{fmt(t_r)} {its['r']} it; ratio "
                     f"{t_c[0] / t_r[0]:.2f}")
        print(line, flush=True)
    print(f"  phase (28) wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def bf16_phases(dev, b_main, *, note, counts, reset_counts, main_runs,
                times, fused_ms, nx=MAIN_NX, bell_nx=40, K=8):
    """Phase (29): bf16. The main-path run, with the launch and cast
    counters set to 0 just before it: CG on the bf16 copy of
    L = poisson3d_27pt(nx) (its values 26 and -1 are bf16-exact, so it is
    the same operator) with cg_110M's float32 b, M None and Jacobi, held
    to the float32 plain extended loop (``cg_full`` over the float32
    extended operator: the same iterations, x within 1e-6); BiCGStab and
    GMRES(20) on the bf16 copy of the convection-diffusion system (not
    bf16-exact: the true residual only); single-reduction CG (the general
    path: kernel 1's plain mode); CG on the bf16 CWELL; a bf16 b at tol
    2e-2 on the DIA (extended and plain modes) and on the CWELL; batched CG
    with B of K columns, float32 and bf16, on the bf16 CWELL and the bf16
    kron(poisson3d_27pt(bell_nx), C8) BELL; ``refined_solve`` with bf16
    inner sweeps and a float64 outer to 1e-8; the gradient in b of the
    bf16 DIA CG. No values cast (``kernels.CAST_COUNTS``). The counts are
    read after that run; then each bf16 build against its plain version
    at the 160^3 shapes (a float32 output within 1e-5 of max|y|, a bf16
    output within one bf16 ulp of |y| plus 1e-6 of max|y|; with a float32
    x, kernel 1 both modes and K4 against the float32 build bit for bit),
    timed (CUDA events, median of 5) beside its bound, its plain version
    and torch's bf16 CSR call where torch takes the pair, and the bf16 CG
    timed beside the float32 plain loop and the fused float32 route
    (``fused_ms``: phase (6)'s (median, min, max))."""
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch import kernels as tk
    from tpu_sparse_torch.api.solver import SolverResult
    from tpu_sparse_torch.solvers.extended import _ext_loop
    from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell, cuda_spmv
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.kernels.spmm_probe import kron_bell
    from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner,
                                                 jacobi_preconditioner)
    from tpu_sparse_torch.solvers import cg_full
    from tpu_sparse_torch.solvers.mixed import refined_solve
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    bf, f32 = torch.bfloat16, torch.float32

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fmt(t):
        return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"

    def true_rel(apply, b, x):
        """Largest ||b - A x|| / ||b|| over the columns, in float32 by the
        plain widened product (no kernel launch)."""
        with torch.no_grad():
            b, x = b.float(), x.float()
            r = torch.linalg.vector_norm(b - apply(x), dim=0)
            return float((r / torch.linalg.vector_norm(b, dim=0)).max())

    phase(f"(29) main path: bf16: CG / BiCGStab / GMRES(20) / cg_sr on the "
          f"bf16 copies of the {nx}^3 systems with float32 and bf16 b, the "
          f"bf16 CWELL and kron BELL with B of {K} columns, refined_solve "
          f"with bf16 sweeps, a gradient in b")
    L = gen.poisson3d_27pt(nx, device=dev)
    n = L.shape[0]
    A = L.with_data(L.data.to(bf))
    check(torch.equal(A.data.float(), L.data), "poisson3d_27pt's values "
          "are not bf16-exact")
    C = gen.convection_diffusion_3d_27pt(nx, device=dev)
    C_bf = C.with_data(C.data.to(bf))
    x8 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        n).astype(np.float32)).to(dev)
    b_cd = C @ x8  # phase (8)'s b (set-up: not counted)
    del C
    W = csr_to_cwell(to_csr(A))
    check(W.vals.dtype == bf, "the CWELL of a bf16 DIA is not bf16")
    bell32, _, _ = kron_bell(dev, bell_nx, np.random.default_rng(SEED))
    bell = bell32.with_data(bell32.blocks.to(bf))
    del bell32
    rng = np.random.default_rng(SEED + 29)
    Bk = torch.from_numpy(rng.standard_normal((n, K)).astype(
        np.float32)).to(dev)
    Bb = torch.from_numpy(rng.standard_normal((bell.shape[0], K)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    L64 = L.with_data(L.data.double())
    b64 = b_main.double()
    # the yardsticks (not counted): the float32 plain extended loop on the
    # same b, with M None and with the bf16 Jacobi diagonal widened
    kw6 = dict(tol=1e-6, atol=0.0, maxiter=None)
    op32 = cuda_spmv.ExtendedStencilOperator(L)
    dinv = jacobi_preconditioner(A).dinv
    yard = {M: _ext_loop("cg", kw6, op32, b_main, None, Mx)
            for M, Mx in ((None, None),
                          ("jacobi", DiagonalPreconditioner(dinv.float())))}
    v_ref = _ext_loop("cg", kw6, op32, w, None, None)[0]
    sync()
    print(f"  n={n}: bf16 DIA {A.data.numel() * 2 / 1e6:.1f} MB of data "
          f"(float32 {L.data.numel() * 4 / 1e6:.1f}); bf16 CWELL "
          f"S={W.srow.shape[1]}; kron BELL n={bell.shape[0]} "
          f"{bell.blocks.numel()} bf16 block values; float32 plain "
          f"extended loop: {int(yard[None][2])} it (M None), "
          f"{int(yard['jacobi'][2])} it (Jacobi)", flush=True)

    # -- the main-path run: every launch from here to the read counts
    solver = tpu_sparse_torch.SparseSolver()
    solve = solver.solve
    reset_counts()   # the launch and cast counters
    out = {}

    def run(label, call, rel, bound):
        before = counts()
        t0 = time.perf_counter()
        x, res = call()
        sync()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        rr = rel(x)
        out[label] = (res, x)
        print(f"  {label}: {res}; true rel res {rr:.2e}; first call "
              f"{wall * 1e3:.1f} ms wall; launches {grew}", flush=True)
        check(res.converged, f"{label} did not converge")
        check(rr <= bound, f"{label}: true relative residual {rr} > "
              f"{bound}")
        return x, res

    def on(M_):
        return lambda x: ref.dia_spmv_wide(M_, x) if x.dim() == 1 \
            else torch.stack([ref.dia_spmv_wide(M_, x[:, j])
                              for j in range(x.shape[1])], 1)

    def on_bell(X):
        return ref.bell_spmm_wide(bell, X)

    for M in (None, "jacobi"):
        x, res = run(f"cg bf16 values, float32 b, M={M}",
                     lambda: solve(A, b_main, method="cg", tol=1e-6, M=M),
                     lambda x: true_rel(on(A), b_main, x), 1e-5)
        xr, _, itr, _ = yard[M]
        e = rel_err(x, xr)
        print(f"    the float32 plain extended loop: {int(itr)} it; x "
              f"rel err {e:.2e}; bit for bit: {torch.equal(x, xr)}",
              flush=True)
        check(res.iterations == int(itr), f"bf16 CG M={M} took "
              f"{res.iterations} it, the float32 loop {int(itr)}")
        check(e <= 1e-6, f"bf16 CG M={M}: x off the float32 loop's by {e}")
    for method, kw in (("bicgstab", {}), ("gmres", dict(restart=20))):
        run(f"{method} bf16 values on the convection-diffusion system",
            lambda: solve(C_bf, b_cd, method=method, tol=1e-6,
                          maxiter=500, **kw),
            lambda x: true_rel(on(C_bf), b_cd, x), 1e-5)
    run("cg_sr bf16 values (general path, kernel 1 plain mode)",
        lambda: solve(A, b_main, method="cg_sr", tol=1e-6, maxiter=500),
        lambda x: true_rel(on(A), b_main, x), 1e-5)
    x, res = run("cg bf16 CWELL, float32 b",
                 lambda: solve(W, b_main, method="cg", tol=1e-6,
                               maxiter=500),
                 lambda x: true_rel(on(A), b_main, x), 1e-5)
    check(abs(res.iterations - out["cg bf16 values, float32 b, M=None"][0]
              .iterations) <= 2, "bf16 CG on the CWELL strays from the DIA")
    bh = b_main.to(bf)
    for label, op_, method in (("DIA", A, "cg"), ("DIA", A, "cg_sr"),
                               ("CWELL", W, "cg")):
        run(f"{method} bf16 b on the bf16 {label} (tol 2e-2)",
            lambda: solve(op_, bh, method=method, tol=2e-2, maxiter=500),
            lambda x: true_rel(on(A), bh, x), 2e-1)
    for label, op_, B_, apply in (("CWELL", W, Bk, on(A)),
                                  ("kron BELL", bell, Bb, on_bell)):
        run(f"cg batched float32 B {K} on the bf16 {label}",
            lambda: solve(op_, B_, method="cg", multi_rhs="batch",
                          tol=1e-6, maxiter=500),
            lambda X: true_rel(apply, B_, X), 1e-5)
        run(f"cg batched bf16 B {K} on the bf16 {label} (tol 2e-2)",
            lambda: solve(op_, B_.to(bf), method="cg", multi_rhs="batch",
                          tol=2e-2, maxiter=500),
            lambda X: true_rel(apply, B_, X), 2e-1)

    def refined():
        x, info, it, res = refined_solve(
            cg_full, L64, b64, tol=1e-8, inner_dtype=bf, inner_tol=1e-2,
            inner_maxiter=500, max_sweeps=10)
        return x, SolverResult(x, int(info) == 0, int(it),
                               float(res / b64.norm()), "krylov",
                               "cg_refined")

    run("refined_solve: bf16 inner CG sweeps, float64 outer, tol 1e-8",
        refined, lambda x: float((b64 - ref.dia_spmv(L64, x)).norm()
                                 / b64.norm()), 1e-8)
    bg = b_main.clone().requires_grad_()
    x, res = solve(A, bg, method="cg", tol=1e-6, precision="full")
    (w * x).sum().backward()
    e_g = rel_err(bg.grad, v_ref)
    print(f"  gradient in b of the bf16 CG ({res.iterations} it): against "
          f"the float32 plain loop's adjoint solve rel err {e_g:.2e}",
          flush=True)
    check(res.converged and e_g <= 1e-6, "the bf16 gradient in b is off")
    del bg, x
    sync()
    main_runs["phase (29)"] = counts()
    casts = tk.CAST_COUNTS["values_casts"]
    print(f"  main-path launches in phase (29): {main_runs['phase (29)']}; "
          f"values casts {casts}", flush=True)
    keys = ("dia_spmv_bf16", "dia_spmv_bf16_f32", "dia_spmv_ext_bf16",
            "dia_spmv_ext_bf16_f32", "cwell_spmv_bf16",
            "cwell_spmv_bf16_f32", "cwell_spmm_bf16", "cwell_spmm_bf16_f32",
            "bell_spmm_bf16", "bell_spmm_bf16_f32")
    for k in keys:
        check(main_runs["phase (29)"][k] > 0,
              f"phase (29): {k} was not launched on the main path")
    check(casts == 0, f"phase (29) cast matrix values {casts} times")

    # -- each bf16 build against its plain version at the 160^3 shapes
    csr = to_csr(A)
    W32 = W.with_data(W.vals.float())
    x32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dev)
    op = cuda_spmv.ExtendedStencilOperator(A)

    def lib_for(csr_):
        return torch.sparse_csr_tensor(csr_.indptr, csr_.indices, csr_.data,
                                       size=csr_.shape)

    def kernel_row(key, kernel, plain, lib_call, nbytes, flops, same=None):
        y1, y0 = kernel(), plain()
        err = float((y1.float() - y0.float()).abs().max())
        scale = float(y0.float().abs().max())
        if y0.dtype == bf:
            ok = bool(torch.all((y1.float() - y0.float()).abs()
                                <= 2.0 ** -7 * y0.float().abs()
                                + 1e-6 * scale))
        else:
            ok = err <= 1e-5 * scale
        check(ok, f"{key} disagrees with its plain version: {err} of "
              f"{scale}")
        bits = "" if same is None else \
            f"; == the float32 build bit for bit: {torch.equal(y1, same())}"
        del y1, y0
        t_k = times(kernel, 10)
        t_p = times(plain, 1)
        lib_ms, lib_note = None, ""
        try:
            e_lib = rel_err(lib_call().float(), plain().float())
            # torch's bf16 products may sum in bf16: a looser bar
            check(e_lib <= 1e-1, f"torch's bf16 call beside {key} computes "
                  "another function")
            t_l = times(lib_call, 10)
            lib_ms = t_l[0]
            lib_note = f"torch bf16 CSR {fmt(t_l)} (rel err {e_lib:.1e})"
        except (RuntimeError, TypeError, NotImplementedError) as exc:
            lib_note = f"torch none ({str(exc).splitlines()[0][:120]})"
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = flops / 67e12 * 1e3
        bound = max(t_bytes, t_ops)
        note(key, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
             library_ms=lib_ms, bound_ms=bound,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"  {key}: kernel {fmt(t_k)}; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {bound / t_k[0]:.2f} of it); plain "
              f"{fmt(t_p)}; {lib_note}; max abs err {err:.2e} (max|y| "
              f"{scale:.2e}){bits}", flush=True)

    lib = lib_for(csr)
    spmv = cuda_spmv.dia_spmv_cuda if cuda else cuda_spmv.dia_spmv
    nd = len(A.offsets)
    for x_, sfx in ((x32, "bf16_f32"), (x32.to(bf), "bf16")):
        s = x_.element_size()
        kernel_row(f"dia_spmv_{sfx}", lambda: spmv(A, x_),
                   lambda: ref.dia_spmv_wide(A, x_),
                   lambda: torch.mv(lib, x_), nd * n * 2 + 2 * n * s,
                   2 * L.nnz,
                   (lambda: spmv(L, x_)) if sfx == "bf16_f32" else None)
        if cuda:
            same = same_bits(spmv(A, x_), cuda_spmv.dia_spmv_v1_cuda(A, x_))
            print(f"  dia_spmv_{sfx}: == the first design (v1) bit for bit: "
                  f"{same}")
            check(same, f"dia_spmv_{sfx} differs from v1")
        xe = op.extend(x_)
        ext = op.apply_cuda if cuda else op
        kernel_row(f"dia_spmv_ext_{sfx}", lambda: ext(xe),
                   lambda: op.apply_plain(xe),
                   lambda: op.extend(torch.mv(lib, x_)),
                   nd * n * 2 + 2 * op.E * s, 2 * L.nnz,
                   (lambda: op32(op32.extend(x_))) if sfx == "bf16_f32"
                   else None)
    plan, cvals = cwell_compact.compact(W)
    nb, S = W.srow.shape
    slots = plan.slots * (2 + plan.idx.element_size()) \
        + plan.boff.numel() * 8 + nb * S * 4
    k4 = cuda_cwell.cwell_spmv_cuda if cuda else cuda_cwell.cwell_spmv
    for x_, sfx in ((x32, "bf16_f32"), (x32.to(bf), "bf16")):
        kernel_row(f"cwell_spmv_{sfx}", lambda: k4(W, x_),
                   lambda: ref.cwell_compact_spmv(plan, cvals, x_),
                   lambda: torch.mv(lib, x_),
                   slots + 2 * n * x_.element_size(), 2 * W.nnz,
                   (lambda: k4(W32, x_)) if sfx == "bf16_f32" else None)
    k6 = cuda_cwell.cwell_spmm_cuda if cuda else cuda_cwell.cwell_spmm
    for B_, sfx in ((Bk, "bf16_f32"), (Bk.to(bf), "bf16")):
        kernel_row(f"cwell_spmm_{sfx}", lambda: k6(W, B_),
                   lambda: ref.cwell_compact_spmm(plan, cvals, B_),
                   lambda: torch.sparse.mm(lib, B_),
                   slots + 2 * n * K * B_.element_size(), 2 * W.nnz * K)
        Y = k6(W, B_)
        same = all(torch.equal(Y[:, j], k4(W, B_[:, j].contiguous()))
                   for j in range(K))
        print(f"  cwell_spmm_{sfx}: every column == K4 bit for bit: {same}")
        if cuda:
            check(same, f"cwell_spmm_{sfx}: a column differs from K4")
        del Y
    del lib, plan, cvals, W32
    bell_csr = to_csr(bell)
    lib = lib_for(bell_csr)
    k8 = cuda_bell.bell_spmm_cuda if cuda else cuda_bell.bell_spmm
    for B_, sfx in ((Bb, "bf16_f32"), (Bb.to(bf), "bf16")):
        kernel_row(f"bell_spmm_{sfx}", lambda: k8(bell, B_),
                   lambda: ref.bell_spmm_wide(bell, B_),
                   lambda: torch.sparse.mm(lib, B_),
                   bell.blocks.numel() * 2 + bell.indices.numel() * 4
                   + 2 * bell.shape[0] * K * B_.element_size(),
                   2 * bell.blocks.numel() * K)
    del lib, bell_csr

    # -- the bf16 CG beside the float32 plain loop and the fused route
    rows = {"bf16 values (extended loop, kernel 1 bf16_f32)":
            lambda: solve(A, b_main, method="cg", tol=1e-6),
            "float32 plain extended loop":
            lambda: _ext_loop("cg", kw6, op32, b_main, None, None)}
    t_solve = {label: times(call, 1, reps=3, warmup=0)
               for label, call in rows.items()}
    for label, t in t_solve.items():
        print(f"  solve cg {label:48s} {fmt(t)}", flush=True)
    print(f"  solve cg {'float32 fused route (phase 6)':48s} "
          f"{fmt(fused_ms)}", flush=True)
    print(f"  phase (29) wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _report_rows(path: str) -> list:
    """The data rows of a harness report's per-matrix tables, as lists of
    cells."""
    rows = []
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if line.startswith("| ") and len(cells) == 8 \
                    and cells[0].isdigit():
                rows.append(cells)
    return rows


def tooling_phases(dev, b_main, x_main, *, counts, reset_counts, main_runs,
                   cg_iters, kernel1_ms, nx=MAIN_NX, runs=3,
                   inverse_args=(), ldc_nx=64):
    """Phase (30): the tooling and the rest of the public API on the card,
    with the launch counters set to 0 just before it and read at its end
    (every launch of the phase is a main-path launch: none compares a
    kernel with its plain version).

    1. ``bench.harness.run_all_benchmarks`` on poisson3d_27pt(nx) in
       float64 (the JAX harness's ``_create_matrix``), krylov / cg and amg,
       tol 1e-8, ``runs`` timed solves after one warm-up: every cell
       converges with no error; the markdown report and CSV go to a
       temporary directory and the report names the card and its power
       limit.
    2. ``run.main(["--benchmark", "--quick"])`` from a temporary working
       directory: its four cells converge.
    3. The Poisson demo at nx (``poisson3d_demo.run``, what ``main``
       runs): converged, true relative residual <= 1e-5, kernels 2 and 3
       launched; its iterations beside phase (4)'s (``cg_iters``; another
       x_true draw).
    4. ``inverse_poisson.main`` on the card (n = 64, 200 steps unless
       ``inverse_args`` says otherwise): final error below 0.4 and within
       1e-6 of the same run on the CPU.
    5. ``save_pytree`` / ``load_pytree`` of phase (4)'s x (``x_main``) and
       the (u, v, p) of an LDC run at ``ldc_nx``, loaded onto the card:
       bit for bit.
    6. ``per_iter_time`` of kernel 1's float32 plain mode on a nx^3
       Poisson matrix (its values scaled by 1/26, so 50 chained products
       stay finite) within 15% of phase (6)'s device ms of the same
       call (``kernel1_ms``); ``trace()`` of one fused CG solve on
       (poisson3d_27pt(nx), ``b_main``) writes a Chrome trace holding
       ``dia_cg`` kernel events.
    """
    import os
    import re
    import shutil
    import tempfile

    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch import run as trun
    from tpu_sparse_torch.apps import inverse_poisson, poisson3d_demo
    from tpu_sparse_torch.apps import ldc as tldc
    from tpu_sparse_torch.bench import harness
    from tpu_sparse_torch.kernels import cuda_spmv
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.utils import checkpoint, timing

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    on_cpu = [] if cuda else ["--cpu"]
    phase(f"(30) main path: the tooling: the benchmark harness at {nx}^3 "
          "(float64, krylov/cg and amg), run.py --benchmark --quick, the "
          f"Poisson demo at nx={nx}, the inverse demo (card against CPU), "
          "checkpoints, per_iter_time and trace()")
    reset_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        # -- 1. the harness at the north star's width
        t0 = time.perf_counter()
        cfg = harness.BenchmarkConfig(
            sizes=[nx ** 3], matrix_types=("poisson3d_27pt",),
            backends=("krylov", "amg"), methods=("cg",), tol=1e-8,
            runs=runs, warmup=1, verbose=False, device=dev.type)
        cells = harness.run_all_benchmarks(cfg)
        for r in cells:
            print(f"  harness {r.backend}/{r.method} {r.matrix_type} "
                  f"n={r.size}: {r.solve_time_ms:.2f} ms (median of "
                  f"{runs}, host clock, synchronized), {r.iterations} it, "
                  f"residual {r.residual:.2e}, memory {r.memory_used_mb} MB"
                  + (f", error {r.error_message}" if r.error_message
                     else ""), flush=True)
            check(not r.error_message and r.converged,
                  f"harness cell {r.backend}/{r.method} failed")
        check(len(cells) == 2, "the harness ran another set of cells")
        report = harness.generate_markdown_report(
            cells, cfg, os.path.join(tmp, "Logger"))
        table = harness.export_csv(cells, os.path.join(tmp, "bench.csv"))
        with open(report) as f:
            text = f.read()
        system = [ln for ln in text.splitlines() if ln.startswith("- **")]
        print("  report: " + "; ".join(ln[2:] for ln in system))
        with open(table) as f:
            print(f"  csv header: {f.readline().strip()}")
        print(f"  peak device memory {harness.device_peak_memory_mb(dev)} "
              f"MB; harness wall {time.perf_counter() - t0:.1f} s")
        if cuda:
            check(torch.cuda.get_device_name(0) in text
                  and re.search(r"power limit\*\*: .+, [0-9.]+ W", text),
                  "the report does not name the card and its power limit")

        # -- 2. run.py --benchmark --quick (the reference protocol)
        quick = os.path.join(tmp, "quick")
        os.makedirs(quick)
        cwd = os.getcwd()
        os.chdir(quick)
        try:
            rc = trun.main(["--benchmark", "--quick"]
                           + ([] if cuda else ["--device", "cpu"]))
        finally:
            os.chdir(cwd)
        (rep,) = os.listdir(os.path.join(quick, "Logger"))
        rows = _report_rows(os.path.join(quick, "Logger", rep))
        print(f"  run.py --benchmark --quick: exit {rc}, cells "
              + ", ".join(f"{c[1]}/{c[2]} n={c[0]} {c[3]} ms {c[5]}"
                          for c in rows))
        check(rc == 0 and len(rows) == 4
              and all(c[5] == "yes" for c in rows),
              "run.py --benchmark --quick: a cell did not converge")

        # -- 3. the Poisson demo (fused CG on the card)
        before = counts()
        demo = poisson3d_demo.run(poisson3d_demo.parse_args(
            ["--nx", str(nx)] + on_cpu))
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        print(f"  demo: {demo['iterations']} it (phase (4)'s fused CG: "
              f"{cg_iters} it on its own x_true draw), {demo['ms']:.2f} ms, "
              f"{demo['gnnz_per_s']:.2f} Gnnz/s, true rel residual "
              f"{demo['rel_residual']:.2e}; launches {grew}")
        check(demo["converged"] and demo["rel_residual"] <= 1e-5,
              "the Poisson demo did not converge to 1e-5")
        if cuda:
            check(grew.get("dia_cg_spmv_dot", 0) > 0
                  and grew.get("dia_cg_update", 0) > 0,
                  "the demo did not run kernels 2 and 3")

        # -- 4. the inverse problem, the card against the CPU
        before = counts()
        t0 = time.perf_counter()
        err_dev = inverse_poisson.main(list(inverse_args) + on_cpu)
        t_dev = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        t0 = time.perf_counter()
        err_cpu = inverse_poisson.main(list(inverse_args) + ["--cpu"])
        print(f"  inverse_poisson: error {err_dev!r} on {dev.type} "
              f"({t_dev:.1f} s), {err_cpu!r} on the CPU "
              f"({time.perf_counter() - t0:.1f} s), difference "
              f"{abs(err_dev - err_cpu):.2e}; launches {grew}", flush=True)
        check(err_dev < 0.4, f"inverse_poisson error {err_dev}")
        check(abs(err_dev - err_cpu) <= 1e-6,
              "inverse_poisson on the card differs from the CPU's")

        # -- 5. checkpoints, loaded onto the card bit for bit
        ldc = tldc.LDCSolver(tldc.LDCConfig(nx=ldc_nx, Re=400.0,
                                            device=dev.type))
        ldc.run(5)
        state = {"x": x_main, "ldc": (ldc.u, ldc.v, ldc.p)}
        path = checkpoint.save_pytree(os.path.join(tmp, "state.npz"), state)
        like = {"x": torch.empty_like(x_main),
                "ldc": tuple(torch.empty_like(t) for t in state["ldc"])}
        back = checkpoint.load_pytree(path, like)
        pairs = [(back["x"], x_main)] + list(zip(back["ldc"], state["ldc"]))
        print(f"  checkpoint of x {tuple(x_main.shape)} and the LDC's "
              f"(u, v, p) at nx={ldc_nx}: "
              f"{os.path.getsize(path) / 1e6:.1f} MB, loaded onto "
              f"{back['x'].device}")
        check(all(a.device == b.device and same_bits(a, b)
                  for a, b in pairs),
              "a checkpoint leaf did not come back bit for bit")

        # -- 6. per_iter_time and trace()
        A = gen.poisson3d_27pt(nx, device=dev)
        A_s = A.with_data(A.data * (1.0 / 26.0))
        v0 = torch.from_numpy(np.random.default_rng(SEED + 30)
                              .standard_normal(A.shape[0])
                              .astype(np.float32)).to(dev)
        k1 = cuda_spmv.dia_spmv_cuda if cuda else cuda_spmv.dia_spmv
        t_it = timing.per_iter_time(lambda v: k1(A_s, v), v0) * 1e3
        print(f"  per_iter_time of kernel 1 (f32 plain mode) at {nx}^3: "
              f"{t_it:.4f} ms; phase (6)'s device time {kernel1_ms:.4f} ms "
              f"({t_it / kernel1_ms:.3f})")
        if cuda:
            check(abs(t_it - kernel1_ms) <= 0.15 * kernel1_ms,
                  "per_iter_time is not within 15% of phase (6)")
        with timing.trace(os.path.join(tmp, "trace")) as log_dir:
            _, res = tpu_sparse_torch.solve(A, b_main, method="cg",
                                            tol=1e-6, maxiter=500)
        (name,) = os.listdir(log_dir)
        with open(os.path.join(log_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        cg_events = [e for e in events if e.get("cat") == "kernel"
                     and "dia_cg" in e.get("name", "")]
        print(f"  trace(): {name}, {len(events)} events, "
              f"{len(cg_events)} dia_cg kernel events "
              f"({sum(e.get('dur', 0) for e in cg_events) / 1e3:.2f} ms); "
              f"the traced solve {res}")
        check(res.converged, "the traced solve did not converge")
        if cuda:
            check(len(cg_events) > 0, "the trace holds no dia_cg kernel")
        del A, A_s, v0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = counts()
    main_runs["phase (30)"] = got
    print(f"  launches in phase (30): "
          f"{ {k: v for k, v in got.items() if v} }")
    if cuda:
        for keys, what in ((("dia_cg_spmv_dot", "dia_cg_update"),
                            "kernels 2-3"),
                           (("dia_spmv_f64", "dia_spmv_ext_f64"), "K3"),
                           (("dia_spmv_f32",), "kernel 1 f32 plain"),
                           (("cwell_spmv_f32", "cwell_spmv_f64"), "K4/K5")):
            check(sum(got[k] for k in keys) > 0,
                  f"{what} was not launched in phase (30)")
    print(f"  phase (30) wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
