"""Typed run configuration with JSON round-trip.

The port's own copy of ``exaspim_tpu/config.py`` (the same classes,
fields, defaults and behaviour, so a JSON file written for one package
configures the other):

* :class:`PrecomputeConfig` / :class:`TrainConfig` /
  :class:`EvaluateConfig` dataclasses with defaults matching the
  reference operating points,
* ``from_json`` / ``to_json`` round-trip and ``replace(**overrides)``,
* unknown keys are rejected (typos fail loudly instead of silently
  running the default).

``python -m exaspim_tpu_torch.train.train_bm4dnet --config-json`` reads a
:class:`TrainConfig`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PrecomputeConfig", "TrainConfig", "EvaluateConfig"]


class _JsonConfig:
    """Shared JSON round-trip behavior for config dataclasses."""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        """Construct from a dict; unknown keys raise."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config keys {sorted(unknown)}; "
                f"known: {sorted(fields)}"
            )
        return cls(**d)

    @classmethod
    def from_json(cls, path: str):
        """Load from a JSON file."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        """Plain-dict form (JSON-serializable)."""
        return dataclasses.asdict(self)

    def to_json(self, path: str):
        """Write to a JSON file; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    def replace(self, **overrides):
        """Copy with field overrides (unknown keys raise)."""
        fields = {f.name for f in dataclasses.fields(self)}
        unknown = set(overrides) - fields
        if unknown:
            raise ValueError(
                f"{type(self).__name__}: unknown overrides "
                f"{sorted(unknown)}"
            )
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class PrecomputeConfig(_JsonConfig):
    """Cache-build knobs (reference precompute defaults: patch 64³,
    σ_bm4d 24, seed 42, gate on — reference precompute.py:278-312)."""

    out_dir: str = ""
    split: str = "train"
    source: str = "synthetic"
    brains_config: Optional[str] = None
    n: int = 500
    patch: Tuple[int, int, int] = (64, 64, 64)
    sigma_bm4d: float = 24.0
    seed: int = 42
    check_incoherence: bool = True
    transform: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig(_JsonConfig):
    """Training knobs (reference operating point: batch 32, lr 1e-3,
    50 epochs, fg_weight 0, cratio weight 10 —
    reference train_bm4dnet.py:180-208)."""

    train_cache: List[str] = dataclasses.field(default_factory=list)
    val_cache: List[str] = dataclasses.field(default_factory=list)
    output_dir: str = ""
    epochs: int = 50
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-2
    fg_weight: float = 0.0
    preserve_foreground: bool = False
    val_every: int = 1000
    seed: int = 42
    width_multiplier: float = 1.0
    bf16: bool = True
    data_parallel: bool = False
    resume: Optional[str] = None
    checkpoint_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5,
            "cratio": 10.0,
        }
    )


@dataclasses.dataclass(frozen=True)
class EvaluateConfig(_JsonConfig):
    """Whole-volume evaluation knobs (reference
    evaluate_bm4dnet.py:184-218)."""

    ckpt: str = ""
    img: str = ""
    out_dir: str = ""
    crop_center: Optional[Tuple[int, int, int]] = None
    crop_shape: Optional[Tuple[int, int, int]] = None
    neuroglancer_xyz: Optional[Tuple[float, float, float]] = None
    offset: Optional[float] = None
    clevel: int = 5
    patch_size: int = 64
    overlap: int = 12
    trim: int = 5
    batch_size: int = 32
    write_output: Optional[str] = None
