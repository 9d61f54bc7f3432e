"""The block-ELL sparse design (the reference's ``sparse`` package).

matrix: ``SparseBlockMatrix`` storage and its converters
ops:    solver-facing primitives (scores, setup pass, residual update,
        matvecs) over it, on the Hopper kernels K5 and K6

The reference's ``sparse/io.py`` (svmlight, coo-npz-v1 shards) is not
ported yet: ROADMAP.md Queue 1 item 7a.
"""
from repro_torch.sparse import ops
from repro_torch.sparse.matrix import SparseBlockMatrix

__all__ = ["SparseBlockMatrix", "ops"]
