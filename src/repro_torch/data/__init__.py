"""Synthetic data of the port: the deterministic token pipeline
(``pipeline.TokenPipeline``) and the batch builders and input specs per
architecture and shape cell (``specs``)."""
