"""Command-line entry points (``python -m deepviewagg_tpu_torch.cli.train``)."""
