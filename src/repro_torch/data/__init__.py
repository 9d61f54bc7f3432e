from repro_torch.data.synthetic import (
    Dataset,
    make_regression,
    make_wide_problem,
    paper_synthetic,
    standardize,
)

__all__ = ["Dataset", "make_regression", "make_wide_problem", "paper_synthetic", "standardize"]
