"""Distribution over a mesh of ranks: the mesh and its collectives, sharded
and halo SpMV and the distributed IR step, distributed trsv and M-solve,
the ring Schur SpGEMM, partitioned (domain-decomposed) factorization."""
from .mesh import Group, Mesh, make_mesh
from .sharded import (ShardedELL, make_sharded_ir_step, pad_rows,
                      shard_ell_rows, sharded_spmv)
from .trsv_sharded import ShardedTrsv, shard_trsv_schedule, sharded_trsv_apply
from .trsv_halo import HaloOp, build_halo_op, halo_trsv_apply
from .exchange import XPlan, build_exchange_plan, xplan_fetch
from .prec_sharded import AGTrsvOp, DistPrec
from .multihost import global_mesh, initialize_multihost
from .halo import HaloSpMV, build_halo_spmv, halo_spmv
from .partition import PartitionedHIF, band_partition
from .schur import schur_spgemm_ring
