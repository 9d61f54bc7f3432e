"""The block-ELL sparse design (the reference's ``sparse`` package).

matrix: ``SparseBlockMatrix`` storage and its converters
io:     svmlight text reader/writer, coo-npz-v1 shards with their sha256
        manifest, and the two-pass shard assembly onto the card
        (ROADMAP.md Queue 1 item 12)
ops:    solver-facing primitives (scores, setup pass, residual update,
        matvecs) over it, on the Hopper kernels K5 and K6
"""
from repro_torch.sparse import io, ops
from repro_torch.sparse.io import (
    COOData,
    convert_svmlight_to_shards,
    iter_shards,
    load_shards,
    load_shards_as_matrix,
    load_svmlight,
    read_manifest,
    save_svmlight,
    write_shards,
)
from repro_torch.sparse.matrix import SparseBlockMatrix

__all__ = [
    "SparseBlockMatrix",
    "COOData",
    "convert_svmlight_to_shards",
    "io",
    "iter_shards",
    "load_shards",
    "load_shards_as_matrix",
    "load_svmlight",
    "read_manifest",
    "save_svmlight",
    "write_shards",
    "ops",
]
