"""Typed configuration from the HOCON ``train`` block.

Counterpart of ``vdnerf_tpu/train/config.py``, holding only the fields that
serving (``valimg`` / ``getfeats``) reads; the training slice adds the rest.
"""

from __future__ import annotations

import dataclasses

from vdnerf_tpu_torch.utils.hocon import Config


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 512
    validate_resolution_level: int = 4
    anneal_end: int = 0
    use_white_bkgd: bool = True
    use_mask: bool = False
    extract_depth: bool = False
    learnable: bool = False

    @classmethod
    def from_conf(cls, conf: Config) -> "TrainConfig":
        t = conf["train"]
        return cls(
            batch_size=t.get_int("batch_size"),
            validate_resolution_level=t.get_int("validate_resolution_level"),
            anneal_end=t.get_int("anneal_end", default=0),
            use_white_bkgd=t.get_bool("use_white_bkgd"),
            use_mask=t.get_bool("use_mask", default=False),
            extract_depth=t.get_bool("extract_depth", default=False),
            learnable=t.get_bool("focal_learnable", default=False),
        )
