"""How accurate the supernodal LU's solve is on the general direct system,
and why: a probe, run on a machine with a CUDA card (or on the CPU at a
small size).

    python3 -m tpu_sparse_torch.direct.stability_probe [--nx 512]

On poisson2d(nx) + 0.1 triu as a general CSR (the JAX bench's
general-direct system) with b = A x_true, x_true from default_rng(0), it
prints:

* an estimate of the condition number (inverse iteration on A^T A with
  scipy's COLAMD SuperLU) and that factorization's own solve residual;
* the true relative residual of SuperLU's own solve with the supernodal
  LU's ordering and options (nested dissection, NATURAL column order,
  ``diag_pivot_thresh`` 0.1 as JAX and 1.0, ``SymmetricMode``): the best
  the level solves of those factors can do;
* the port's level-scheduled solve in float64 and float32 (without and
  with the refinement step), once with batched triangular solves of the
  diagonal blocks (the port's) and once with their explicit inverses
  applied by a matmul (the JAX package's design), with the factor's
  wall time, the levels and the time of one solve.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def skewed_poisson(nx: int):
    """poisson2d(nx) + 0.1 triu(poisson2d(nx), 1), float64 scipy CSR."""
    import scipy.sparse as sp

    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_scipy_csr

    S = to_scipy_csr(gen.poisson2d(nx, dtype=np.float64, device="cpu"))
    S = (S + 0.1 * sp.triu(S, k=1)).tocsr()
    S.sort_indices()
    return S


def _inverse_level_solve(diag, packs, meta, ranges, bp):
    """The JAX package's level solve: explicit inverses of the diagonal
    blocks (taken in float64) applied by one full-precision matmul a
    level."""
    from tpu_sparse_torch.direct.banded import full_fp32_matmul
    from tpu_sparse_torch.kernels import spmv

    inv = torch.linalg.inv(diag.double()).to(diag.dtype)
    s = diag.shape[1]
    y = torch.zeros_like(bp)
    for (a, b), groups, shapes in zip(ranges, packs, meta):
        seg = bp[a:b]
        if groups is not None:
            corr = [bp.new_zeros(r) if N is None else spmv(N, y)
                    for N, (_, r) in zip(groups, shapes)]
            seg = seg - torch.cat(corr)
        with full_fp32_matmul():
            y[a:b] = torch.bmm(inv[a // s:b // s],
                               seg.reshape(-1, s, 1)).reshape(-1)
    return y


def main(argv=None) -> None:
    import scipy.sparse.linalg as spl

    from tpu_sparse_torch.direct import supernodal
    from tpu_sparse_torch.direct.ordering import nested_dissection
    from tpu_sparse_torch.kernels import spmv
    from tpu_sparse_torch.sparse.convert import csr_from_arrays

    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=512)
    nx = ap.parse_args(argv).nx
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    else:
        print("device: cpu")
    S = skewed_poisson(nx)
    n = S.shape[0]
    xt = np.random.default_rng(0).standard_normal(n)
    b = S @ xt

    def rel(x, SS=S, bb=b):
        return float(np.linalg.norm(bb - SS @ np.asarray(x, np.float64))
                     / np.linalg.norm(bb))

    t0 = time.perf_counter()
    lu = spl.splu(S.tocsc())
    print(f"n = {n}: scipy SuperLU (COLAMD, partial pivoting) "
          f"{time.perf_counter() - t0:.1f} s, max|U| {abs(lu.U).max():.3e};"
          f" its solve: true rel res {rel(lu.solve(b)):.3e}", flush=True)
    v = np.random.default_rng(1).standard_normal(n)
    for _ in range(15):
        w = lu.solve(lu.solve(v), trans="T")
        v = w / np.linalg.norm(w)
    smin = 1 / np.sqrt(np.linalg.norm(lu.solve(lu.solve(v), trans="T")))
    u = np.random.default_rng(2).standard_normal(n)
    for _ in range(30):
        u = S.T @ (S @ u)
        u /= np.linalg.norm(u)
    smax = float(np.sqrt(np.linalg.norm(S.T @ (S @ u))))
    print(f"sigma_min ~ {smin:.3e}, sigma_max ~ {smax:.3f}: condition ~ "
          f"{smax / smin:.3e}", flush=True)
    sigma, _ = nested_dissection(S, leaf=896)
    Ap = S[sigma][:, sigma].tocsc()
    for thr in (0.1, 1.0):
        t0 = time.perf_counter()
        nd = spl.splu(Ap, permc_spec="NATURAL", diag_pivot_thresh=thr,
                      options=dict(SymmetricMode=True))
        x = np.empty(n)
        x[sigma] = nd.solve(b[sigma])
        print(f"ND SuperLU, diag_pivot_thresh {thr}: "
              f"{time.perf_counter() - t0:.1f} s, max|U| "
              f"{abs(nd.U).max():.3e}, min|diag U| "
              f"{abs(nd.U.diagonal()).min():.3e}; its solve: true rel res "
              f"{rel(x):.3e}", flush=True)

    for dt in (torch.float64, torch.float32):
        A = csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                            device=dev)
        A = A.with_data(A.data.to(dt))
        t0 = time.perf_counter()
        f = supernodal.SupernodalLU.factor(A, with_transpose=False)
        print(f"supernodal factor, {str(dt)[6:]}: "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)
        bt = torch.from_numpy(b).to(dev, dt)

        def solve(r, inverse):
            bp = f._scatter(r, f.in_idx)
            if inverse:
                y = _inverse_level_solve(f.diagL, f.packsL, f.metaL,
                                         f.rangesL, bp)
                z = _inverse_level_solve(f.diagU, f.packsU, f.metaU,
                                         f.rangesU, y[f.mid_idx])
                return z[f.out_idx]
            return f.solve(r)

        for inverse in (False, True):
            with torch.no_grad():
                x0 = solve(bt, inverse)
                x1 = x0 + solve(bt - spmv(A, x0), inverse)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(bt, inverse)
            if dev == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            how = ("explicit inverses (JAX)" if inverse
                   else "triangular solves (port)")
            print(f"level solve, {str(dt)[6:]}, {how}: levels "
                  f"{len(f.rangesL)}/{len(f.rangesU)}; true rel res "
                  f"{rel(x0.double().cpu().numpy()):.3e}, refined "
                  f"{rel(x1.double().cpu().numpy()):.3e}; one solve "
                  f"{ms:.1f} ms wall", flush=True)
        del f


if __name__ == "__main__":
    main()
