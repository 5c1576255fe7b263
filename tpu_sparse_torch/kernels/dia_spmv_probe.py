"""Design probe for kernel 1's plain mode (``csrc/dia_spmv.cu``) on one GPU.

    python3 -m tpu_sparse_torch.kernels.dia_spmv_probe [nx]

Three plain-mode designs: "strided" (a CTA owns 256 R rows, thread t the
rows t, t + 256, ...: v1's coalesced loads, R rows in registers) and
"vector" (thread t owns R consecutive rows and reads each diagonal's R
values as one vector load of 4, 8 or 16 bytes), both in ``dia_spmv.cu``
with no column tests on tiles inside the interior, and "ring" (a
persistent grid streaming (ndiag x T) boxes of data through shared
memory by bulk async copies, ``dia_spmv_ring.cuh``, launched by nothing
but this probe). It instantiates them at several R, ptxas occupancy
targets (min CTAs a SM) and ring sizes for every build (f32, f64, c64,
c128, bf16, bf16_f32) in one extra library (a generated file that
includes both sources, compiled with the package's nvcc flags), prints
their ptxas lines (registers, stack, spills), and on
``poisson3d_27pt(nx)`` (default 160; complex: D^H A D, D = diag(exp(i
theta)), as smoke phase (28)) in f32, bf16_f32, bf16, c64 and c128, and
in f64 at 64^3, at nx^3 and at the lid-driven cavity's shape
(``poisson2d(256)``: 65,536 rows, 5 diagonals):

* checks every design, v1 (``dia_spmv_v1.cuh``) and the shipped entry
  (``cuda_spmv.dia_spmv_cuda``) against ``reference.dia_spmv`` /
  ``dia_spmv_wide`` (1e-5 of max|y| for f32 / c64 / bf16_f32 outputs,
  1e-13 f64, 1e-12 c128, one bf16 ulp for bf16 outputs) and against v1,
  bit for bit;
* times them in turns (each visited twice, in opposite orders) with CUDA
  events, every call after an L2 flush (median of the calls), and
  back-to-back (warm L2), beside the bound (the bytes over 3.35 TB/s) and
  cuSPARSE's CSR ``torch.mv`` of the same matrix where cuSPARSE takes the
  dtype pair.

Needs nvcc and a CUDA device; it changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

# values' and x's C types by build
TYPES = {"f32": ("float", "float"), "f64": ("double", "double"),
         "c64": ("ts_c64", "ts_c64"), "c128": ("ts_c128", "ts_c128"),
         "bf16": ("ts_bf16", "ts_bf16"), "bf16_f32": ("ts_bf16", "float")}
# rows a thread of the vector design: 16 bytes of values (32 for complex)
VECTOR_ROWS = {"f32": 4, "f64": 2, "c64": 4, "c128": 2, "bf16": 8,
               "bf16_f32": 8}
STRIDED, VECTOR, RING = 0, 1, 2
# the ring's (rows a tile, stages) by build: stages of about 28-55 KB at
# 27 diagonals
RING_SIZES = {"f32": ((256, 2),), "f64": ((256, 2),), "c64": ((128, 2),),
              "c128": ((128, 2),), "bf16": ((256, 2),),
              "bf16_f32": ((256, 2),)}


def designs(sfx: str) -> dict:
    """name -> (design, a, b): for the strided and vector designs a = rows
    a thread, b = min CTAs a SM for ptxas; for the ring a = rows a tile, b
    = stages."""
    rv = VECTOR_ROWS[sfx]
    out = {"strided R=1": (STRIDED, 1, 1),
           "strided R=1 minB=8": (STRIDED, 1, 8),
           "strided R=2 minB=4": (STRIDED, 2, 4),
           f"vector R={rv}": (VECTOR, rv, 1)}
    for r, mb in ((2, 1), (2, 4), (2, 8), (4, 4)):
        if r < rv or (r == rv and mb > 1):
            out[f"vector R={r}" + (f" minB={mb}" if mb > 1 else "")] = \
                (VECTOR, r, mb)
    for t, st in RING_SIZES[sfx]:
        out[f"ring {t}x{st}"] = (RING, t, st)
    return out


def symbol(spec, sfx: str) -> str:
    design, a, b = spec
    return f"probe_dia_{design}_{a}_{b}_{sfx}"


_HELPER = r'''
#include "dia_spmv.cu"
#include "dia_spmv_ring.cuh"

// One launch of a design at R rows a thread (the ring: R rows a tile, MINB
// stages) whatever the size (the probe forces R); unrolled instances for
// 27 and 5 diagonals, else the generic.
template <typename V, typename X, int D, int R, int MINB>
static int probe_dia_launch(const V* data, long long ld, const int* offsets,
                            int ndiag, const X* x, X* y, long long n_rows,
                            long long n_cols, cudaStream_t s) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs) || n_rows <= 0 ||
      n_cols < 0 || ld < n_rows)
    return TS_BAD_ARGUMENT;
  constexpr long long VEC = R * sizeof(V) < 16 ? R * sizeof(V) : 16;
  if (D == TS_DIA_VECTOR && R > 1 &&
      ((size_t)data % VEC != 0 || (ld * sizeof(V)) % VEC != 0))
    return TS_BAD_ARGUMENT;
  const TsDiaGeometry g = ts_dia_geometry(offs, ndiag, n_rows, n_cols, ld, 0,
                                          (int)sizeof(V), TS_DIA_STRIDED, 1,
                                          0);
  if constexpr (D == TS_DIA_RING) {
    if ((size_t)data % 16 != 0 || (ld * sizeof(V)) % 16 != 0)
      return TS_BAD_ARGUMENT;
    const int sms = ts_sm_count();
    if (ndiag == 27)
      return launch_dia_ring_nd<V, X, R, MINB, 27>(
          data, ld, offs, ndiag, x, y, n_rows, n_cols, g.lo, g.hi, sms, s);
    if (ndiag == 5)
      return launch_dia_ring_nd<V, X, R, MINB, 5>(
          data, ld, offs, ndiag, x, y, n_rows, n_cols, g.lo, g.hi, sms, s);
    return launch_dia_ring_nd<V, X, R, MINB, 0>(
        data, ld, offs, ndiag, x, y, n_rows, n_cols, g.lo, g.hi, sms, s);
  } else {
    const long long t = (long long)TS_BLOCK * R;
    const long long grid = (n_rows + t - 1) / t;
    if (ndiag == 27)
      launch_dia_plain_nd<V, X, D, R, MINB, 27>(data, ld, offs, ndiag, x, y,
                                                n_rows, n_cols, g.lo, g.hi,
                                                grid, s);
    else if (ndiag == 5)
      launch_dia_plain_nd<V, X, D, R, MINB, 5>(data, ld, offs, ndiag, x, y,
                                               n_rows, n_cols, g.lo, g.hi,
                                               grid, s);
    else
      launch_dia_plain_nd<V, X, D, R, MINB, 0>(data, ld, offs, ndiag, x, y,
                                               n_rows, n_cols, g.lo, g.hi,
                                               grid, s);
  }
  return (int)cudaGetLastError();
}
'''


def build_designs(work: Path) -> "tuple[ctypes.CDLL, list]":
    """The library of every design and build, and the ptxas lines of its
    plain-mode kernels."""
    from tpu_sparse_torch.kernels import _build

    src = work / "dia_spmv_probe.cu"
    lines = [_HELPER]
    for sfx, (V, X) in TYPES.items():
        for spec in designs(sfx).values():
            d, r, mb = spec
            lines.append(
                f'extern "C" int {symbol(spec, sfx)}(const void* data, '
                f"long long ld, const int* offs, int ndiag, const void* x, "
                f"void* y, long long n_rows, long long n_cols, cudaStream_t "
                f"s) {{ return probe_dia_launch<{V}, {X}, {d}, {r}, {mb}>("
                f"(const {V}*)data, ld, offs, ndiag, (const {X}*)x, ({X}*)y,"
                f" n_rows, n_cols, s); }}")
    src.write_text("\n".join(lines) + "\n")
    lib = work / "dia_spmv_probe.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    out = (proc.stdout + proc.stderr).splitlines()
    info = []
    for i, ln in enumerate(out):
        if "Compiling entry" not in ln or "dia_spmv" not in ln:
            continue
        name = ln.split("'")[1]
        used = next(u for u in out[i:] if "Used" in u).strip()
        stack = next((u.strip() for u in out[i:i + 4] if "stack frame" in u),
                     "")
        info.append(f"{name[:72]}: {used}; {stack}")
    loaded = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in TYPES:
        for spec in designs(sfx).values():
            fn = getattr(loaded, symbol(spec, sfx))
            fn.argtypes = [P, L, P, I, P, P, L, L, P]
            fn.restype = ctypes.c_int
    return loaded, info


def operands(key: str, nx: int, dev):
    """(label, A, x, build suffix) of a probe case."""
    import numpy as np
    import torch

    from tpu_sparse_torch.sparse import generators as gen

    rng = np.random.default_rng(14)
    if key == "ldc":
        A = gen.poisson2d(256, dtype=np.float64, device=dev)
        label, sfx = "f64 poisson2d(256) (the LDC's shape)", "f64"
    elif key.startswith("f64"):
        m = int(key.split("_")[1])
        A = gen.poisson3d_27pt(m, dtype=np.float64, device=dev)
        label, sfx = f"f64 poisson3d_27pt({m})", "f64"
    else:
        A = gen.poisson3d_27pt(nx, device=dev)
        sfx = key
        label = f"{key} poisson3d_27pt({nx})"
        if key in ("c64", "c128"):
            dt = torch.complex64 if key == "c64" else torch.complex128
            theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, A.shape[0]))
            D = torch.polar(torch.ones_like(theta), theta).to(dev)
            data = A.data.to(dt)
            n = A.shape[0]
            for d, o in enumerate(A.offsets):
                i0, i1 = max(0, -o), min(n, n - o)
                data[d, i0:i1] *= (D[i0:i1].conj() * D[i0 + o:i1 + o]).to(dt)
            A = A.with_data(data)
            label += " D^H A D"
        elif key.startswith("bf16"):
            A = A.with_data(A.data.to(torch.bfloat16))
    n = A.shape[1]
    if sfx in ("c64", "c128"):
        x = torch.from_numpy(rng.standard_normal(n) + 1j
                             * rng.standard_normal(n)).to(dev, A.data.dtype)
    else:
        xdt = {"f32": torch.float32, "f64": torch.float64,
               "bf16": torch.bfloat16, "bf16_f32": torch.float32}[sfx]
        x = torch.from_numpy(rng.standard_normal(n)).to(dev, xdt)
    return label, A, x, sfx


def close(sfx, y, y0) -> "tuple[float, bool]":
    """max abs error against the plain version, and whether it is within
    the build's limit."""
    import torch

    err = float((y.to(y0.dtype) - y0).abs().max())
    scale = float(y0.abs().max())
    if sfx == "bf16":
        yf, y0f = y.float(), y0.float()
        ok = bool(torch.all((yf - y0f).abs() <= 2.0 ** -7 * y0f.abs()
                            + 1e-6 * scale))
    else:
        tol = {"f64": 1e-13, "c128": 1e-12}.get(sfx, 1e-5)
        ok = err <= tol * scale
    return err, ok


def main(argv) -> int:
    import numpy as np
    import torch

    from tpu_sparse_torch.kernels import _build, cuda_spmv
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.utils.timing import (cuda_flushed_times_ms,
                                               cuda_times_ms)

    if not torch.cuda.is_available():
        print("dia_spmv_probe: no CUDA device", file=sys.stderr)
        return 2
    nx = int(argv[1]) if len(argv) > 1 else 160
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        lib, info = build_designs(Path(tmp))
        print("ptxas:\n  " + "\n  ".join(info), flush=True)
        main_lib = _build.library()
        for key in ("f32", "bf16_f32", "bf16", "c64", "c128", "f64_64",
                    f"f64_{nx}", "ldc"):
            label, A, x, sfx = operands(key, nx, dev)
            n, m = A.shape
            data = A.data.contiguous()
            offs, offs_ptr = _build.int_array(A.offsets)
            nd = len(A.offsets)

            def entry(fn, sfx=sfx, data=data, x=x, offs_ptr=offs_ptr, nd=nd,
                      n=n, m=m):
                def call():
                    y = torch.empty(n, dtype=x.dtype, device=dev)
                    rc = fn(data.data_ptr(), data.shape[1], offs_ptr, nd,
                            x.data_ptr(), y.data_ptr(), n, m, stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: {rc}")
                    return y
                return call

            calls = {"v1": entry(getattr(main_lib, f"ts_dia_spmv_v1_{sfx}"))}
            for name, spec in designs(sfx).items():
                calls[name] = entry(getattr(lib, symbol(spec, sfx)))
            calls["shipped entry"] = lambda A=A, x=x: \
                cuda_spmv.dia_spmv_cuda(A, x)
            wide = sfx.startswith("bf16")
            y0 = (ref.dia_spmv_wide if wide else ref.dia_spmv)(A, x)
            y_v1 = calls["v1"]()
            torch.cuda.synchronize()
            for name, call in calls.items():
                y1, y2 = call(), call()
                torch.cuda.synchronize()
                err, ok = close(sfx, y1, y0)
                same = torch.equal(y1, y_v1) and torch.equal(y1, y2)
                if not (ok and same):
                    failed.append(f"{label} {name}: err {err:.2e} "
                                  f"(ok {ok}), == v1 {same}")
            lib_call, lib_note = None, "none"
            if sfx != "bf16_f32":
                csr = conv.to_csr(A)
                t = torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                            csr.data, size=A.shape)
                del csr
                try:
                    e_lib = float((torch.mv(t, x).to(y0.dtype) - y0).abs()
                                  .max() / y0.abs().max())
                    lib_call = lambda t=t, x=x: torch.mv(t, x)  # noqa: E731
                    lib_note = f"rel err {e_lib:.1e}"
                except RuntimeError as exc:
                    lib_note = f"none ({str(exc).splitlines()[0][:80]})"
            if lib_call is not None:
                calls["cuSPARSE torch.mv (CSR)"] = lib_call
            flushed = {k: [] for k in calls}
            warm = {k: [] for k in calls}
            for name in list(calls) + list(reversed(calls)):
                flushed[name] += cuda_flushed_times_ms(calls[name], flush)
                warm[name] += cuda_times_ms(calls[name], warmup=2, reps=3,
                                            inner=20)
            nbytes = (data.element_size() * nd * n
                      + x.element_size() * (n + m))
            bound = nbytes / 3.35e12 * 1e3
            geo = cuda_spmv.plain_geometry(
                sfx, list(A.offsets), n, m, data.shape[1], data.data_ptr(),
                torch.cuda.get_device_properties(dev).multi_processor_count)
            print(f"\n{label}: n={n}, {nd} diagonals; bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB); shipped geometry {geo}; "
                  f"cuSPARSE {lib_note}", flush=True)
            v1_ms = float(np.median(flushed["v1"]))
            for name in calls:
                f = float(np.median(flushed[name]))
                w = float(np.median(warm[name]))
                print(f"  {name:26s} flushed {f:.4f} ms (min "
                      f"{min(flushed[name]):.4f} max {max(flushed[name]):.4f})"
                      f" {bound / f:.2f} of bound, {f / v1_ms:.3f} of v1; "
                      f"warm {w:.4f} ms", flush=True)
            del A, x, data, calls, y0, y_v1
            torch.cuda.empty_cache()
    if failed:
        print("FAILED:\n  " + "\n  ".join(failed), flush=True)
        return 1
    print("every design and the shipped entry equal v1 bit for bit and "
          "meet the plain version's limits", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
