"""Experiment logging: JSONL always, TensorBoard / wandb when available.

The port of ``deepviewagg_tpu/utils/logging.py``, unchanged in behaviour.
The reference publishes tracker metrics to wandb and tensorboard
(metrics/base_tracker.py:80, utils/wandb_utils.py:30-110).  Here a single ``MetricLogger`` fans out to: a run-dir
``metrics.jsonl`` (always), ``torch.utils.tensorboard`` and ``wandb`` when
importable and enabled.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional

__all__ = ["MetricLogger", "git_info", "save_git_diff"]


def git_info(repo_dir: Optional[str] = None) -> Dict[str, str]:
    """Commit sha + dirty flag, the reference's wandb provenance capture
    (utils/wandb_utils.py:52-70); ``{}`` where git fails."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=repo_dir, timeout=5,
        ).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True, text=True,
            cwd=repo_dir, timeout=5,
        ).stdout.strip())
        return {"sha": sha, "dirty": str(dirty)}
    except Exception:
        return {}


def save_git_diff(run_dir: str, repo_dir: Optional[str] = None) -> None:
    """Write the working-tree diff next to the run (the reference uploads
    it with every wandb run, utils/wandb_utils.py:63-70) so a dirty-tree
    experiment stays reproducible."""
    try:
        diff = subprocess.run(
            ["git", "diff", "HEAD"], capture_output=True, text=True,
            cwd=repo_dir, timeout=10,
        ).stdout
        if diff.strip():
            with open(os.path.join(run_dir, "git_diff.patch"), "w") as f:
                f.write(diff)
    except Exception:
        pass


class MetricLogger:
    def __init__(self, run_dir: Optional[str], use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.run_dir = run_dir
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            # no-ops on a clean tree, swallows git errors
            save_git_diff(run_dir, os.path.dirname(os.path.abspath(__file__)))
        if use_tensorboard and run_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                self._tb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(dir=run_dir, **(wandb_kwargs or {}))
            except Exception as e:  # requested but unavailable: say so once
                import sys

                print(f"[logging] wandb requested but disabled: {e}",
                      file=sys.stderr)
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        if self._jsonl:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()
