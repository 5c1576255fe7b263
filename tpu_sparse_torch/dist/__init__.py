"""Row-partitioned distribution over ``torch.distributed``: the port of
``tpu_sparse/dist/``. NCCL joins the cards (one process per card), gloo
the CPU ranks; the local products are the port's kernels (kernel 1's
extended mode, K4 / K5, K6 / K7) on each rank's rows."""

from tpu_sparse_torch.dist.mesh import (RowMesh, initialize_multihost,
                                        make_row_mesh)
from tpu_sparse_torch.dist.partition import (gather_vector, local_rows,
                                             shard_dia, shard_vector)
from tpu_sparse_torch.dist.solvers import (distributed_bicgstab,
                                           distributed_block_cg,
                                           distributed_cg, distributed_gmres,
                                           distributed_matvec_op,
                                           distributed_minres)
from tpu_sparse_torch.dist.spmv import halo_dia_spmv, make_halo_spmv

__all__ = [
    "RowMesh", "initialize_multihost", "make_row_mesh",
    "shard_dia", "shard_vector", "local_rows", "gather_vector",
    "halo_dia_spmv", "make_halo_spmv",
    "distributed_cg", "distributed_block_cg", "distributed_minres",
    "distributed_matvec_op", "distributed_bicgstab", "distributed_gmres",
]
