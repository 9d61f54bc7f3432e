from repro_torch.data.proxies import (
    PROXY_SPECS,
    ProxySpec,
    SparseDataset,
    dense_proxy_bytes,
    make_proxy,
    make_sparse_coo,
    make_sparse_proxy,
    make_sparse_wide_problem,
)
from repro_torch.data.synthetic import (
    Dataset,
    make_regression,
    make_wide_problem,
    paper_synthetic,
    standardize,
)

__all__ = [
    "Dataset", "PROXY_SPECS", "ProxySpec", "SparseDataset", "dense_proxy_bytes",
    "make_proxy", "make_regression", "make_sparse_coo", "make_sparse_proxy",
    "make_sparse_wide_problem", "make_wide_problem", "paper_synthetic", "standardize",
]
