"""Applications built on tpu_sparse_torch: the lid-driven cavity
(``python -m tpu_sparse_torch.apps.ldc``)."""
