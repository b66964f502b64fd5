"""Visualization: per-epoch PLY sample dumps."""

from .viewer import save_ply_snapshot  # noqa: F401
