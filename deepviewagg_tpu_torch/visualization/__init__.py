"""Visualization: per-epoch PLY dumps + standalone HTML multimodal viewer."""

from .viewer import export_html, save_ply_snapshot  # noqa: F401
