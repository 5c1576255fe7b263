"""Extended-layout Krylov runs (forward); the adjoint lands later."""

from tpu_sparse_torch.autodiff.implicit import ext_run, ext_run_f64

__all__ = ["ext_run", "ext_run_f64"]
