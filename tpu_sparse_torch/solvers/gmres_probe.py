"""Timing probe for the GMRES restart cycles on one GPU.

    python3 tpu_sparse_torch/solvers/gmres_probe.py [--root DIR] [--nx 160]
                                                    [--k 8]

Times GMRES(20) with ``solve_method="incremental"`` (Givens QR) and
``"batched"`` (one least-squares per cycle) on
``convection_diffusion_3d_27pt(nx)`` in float32, tol 1e-6: single-RHS
``gmres_full`` on the DIA matrix (kernel 1), median and min-max of 5 with
CUDA events, and ``batch_gmres`` with B of k columns on the CWELL pack of
the same matrix taken as a general CSR (K6/K7), median and min-max of 3.
Right-hand sides are b = A x_true with x_true from
``numpy.random.default_rng(0)``. Prints the restart cycles, the true
relative residual and the times, then one JSON line.

``--root`` names the checkout whose ``tpu_sparse_torch`` is imported (by
default the one holding this file), so that two commits can be timed on
one card: run it with the other commit unpacked under ``--root``, in the
order parent, change, change, parent. Needs nvcc and a CUDA device; it
changes nothing in the package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import tpu_sparse_torch
    from tpu_sparse_torch.solvers.batched import batch_gmres
    from tpu_sparse_torch.solvers.krylov import gmres_full
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    if not torch.cuda.is_available():
        print("gmres_probe needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; tpu_sparse_torch from {Path(tpu_sparse_torch.__file__).parent}")

    def times(fn, reps):
        fn()  # warm-up
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return [float(np.median(ts)), min(ts), max(ts)]

    A = gen.convection_diffusion_3d_27pt(args.nx)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = A @ torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    W = csr_to_cwell(to_csr(A))
    B = A @ torch.from_numpy(rng.standard_normal((n, args.k)).astype(
        np.float32)).cuda()
    norm = torch.linalg.vector_norm
    out = {"card": card, "nx": args.nx, "k": args.k}
    for method in ("incremental", "batched"):
        def single():
            return gmres_full(A, b, restart=20, tol=1e-6, maxiter=500,
                              solve_method=method)

        def multi():
            return batch_gmres(W, B, restart=20, tol=1e-6, maxiter=500,
                               solve_method=method)

        x, info, k, _ = single()
        rel = float(norm(b - A @ x) / norm(b))
        t = times(single, 5)
        X, infos, ks, _ = multi()
        R = B - torch.stack([A @ X[:, j].contiguous() for j in range(args.k)],
                            1)
        rel_b = float((norm(R, dim=0) / norm(B, dim=0)).max())
        t_b = times(multi, 3)
        out[method] = {"cycles": int(k), "info": int(info),
                       "true_rel_res": rel, "ms": t,
                       "batch_cycles": int(ks.max()),
                       "batch_info": int(infos.min()),
                       "batch_true_rel_res": rel_b, "batch_ms": t_b}
        print(f"  gmres(20) {method}: {int(k)} cycles, info {int(info)}, "
              f"true rel res {rel:.3e}, {t[0]:.2f} ms ({t[1]:.2f}-"
              f"{t[2]:.2f}); batch_gmres k={args.k}: {int(ks.max())} cycles, "
              f"worst column {rel_b:.3e}, {t_b[0]:.2f} ms ({t_b[1]:.2f}-"
              f"{t_b[2]:.2f})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
