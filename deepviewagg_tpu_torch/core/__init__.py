"""core of the PyTorch port (see deepviewagg_tpu_torch/__init__.py)."""
