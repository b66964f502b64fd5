"""Checkpointing: single-directory runs with per-metric best + latest.

The port of ``deepviewagg_tpu/train/checkpoint.py`` (the reference keeps one
``.pt`` holding the run config plus model weights keyed ``best_<metric>`` /
``latest`` and the optimizer state, metrics/model_checkpoint.py:21-391):
the same files under the same keys — ``run.json`` (the run config, stem
kernel pinned), ``best.json`` (the best value of each tracked metric) and
one file per key (``latest``, ``best_<metric>``, ``crash``).  A key's file
is ``<key>.pt``, a ``torch.save`` of ``{step, model, optimizer}`` (the
model's and the optimizer's ``state_dict``), not the JAX package's flax
msgpack: the two packages' checkpoints are not interchangeable
(:mod:`deepviewagg_tpu_torch.utils.from_jax` converts JAX variables).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, run_dir: str, run_config: Optional[Dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._best: Dict[str, float] = {}
        if run_config is not None:
            # pin the stem kernel into every stored run config, so that a
            # later change of the default cannot rebuild another stem shape
            model = run_config.get("model")
            if isinstance(model, dict):
                model.setdefault("overrides", {}).setdefault("stem_kernel", 3)
            with open(os.path.join(run_dir, "run.json"), "w") as f:
                json.dump(run_config, f, indent=2, default=str)
        best_path = os.path.join(run_dir, "best.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                self._best = json.load(f)

    # -- low level --------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.run_dir, f"{key}.pt")

    def save_state(self, key: str, state) -> None:
        """Save a ``TrainState``: its step, model and optimizer."""
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": state.tx.state_dict()}, self._path(key))

    def restore_state(self, key: str, state):
        """Restore into an existing (template) ``TrainState`` in place: the
        model's parameters and buffers, the optimizer's state and the step,
        bit for bit; returns the state."""
        payload = torch.load(self._path(key), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.tx.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def restore_variables(self, key: str, model: nn.Module) -> nn.Module:
        """Load only the model's parameters and buffers — inference-time
        loading, independent of the optimizer the checkpoint was trained
        with."""
        payload = torch.load(self._path(key), map_location="cpu",
                             weights_only=True)
        model.load_state_dict(payload["model"])
        return model

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def load_run_config(self) -> Optional[Dict]:
        p = os.path.join(self.run_dir, "run.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    # -- best-model bookkeeping (model_checkpoint.py:311-380) -------------
    def save_best(self, state, metrics: Dict[str, float],
                  directions: Dict[str, str]) -> Dict[str, bool]:
        """Save 'latest' + any 'best_<metric>' that improved; returns which
        metrics improved."""
        self.save_state("latest", state)
        improved = {}
        for name, value in metrics.items():
            direction = directions.get(name)
            if direction is None:
                continue
            prev = self._best.get(name)
            better = (
                prev is None
                or (direction == "max" and value > prev)
                or (direction == "min" and value < prev)
            )
            if better:
                self._best[name] = float(value)
                self.save_state(f"best_{name}", state)
            improved[name] = better
        with open(os.path.join(self.run_dir, "best.json"), "w") as f:
            json.dump(self._best, f, indent=2)
        return improved

    @property
    def best_metrics(self) -> Dict[str, float]:
        return dict(self._best)
