from repro_torch.parallel.pipeline import make_pipeline_fn

__all__ = ["make_pipeline_fn"]
