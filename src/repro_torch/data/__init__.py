from repro_torch.data.pipeline import TokenPipeline, make_batch_fn  # noqa: F401
