"""Backward-compatible config version migration (reference
``detectron2/config/compat.py:1-229``).

Old configs (VERSION 1) used different key names; ``upgrade_config`` walks
them to the current VERSION 2 surface and ``downgrade_config`` reverses it —
the renames handled are the reference's ConverterV2 set (RPN_HEAD -> RPN,
per-dataset test sizes, etc.).
"""

import logging
from typing import List, Optional, Tuple

from .cfgnode import CfgNode as CN

logger = logging.getLogger(__name__)

__all__ = ["upgrade_config", "downgrade_config", "guess_version"]

_VERSION = 2


def upgrade_config(cfg: CN, to_version: Optional[int] = None) -> CN:
    cfg = cfg.clone()
    if to_version is None:
        to_version = _VERSION
    assert cfg.VERSION <= to_version, (cfg.VERSION, to_version)
    for k in range(cfg.VERSION, to_version):
        converter = globals()[f"ConverterV{k + 1}"]
        converter.upgrade(cfg)
        cfg.VERSION = k + 1
    return cfg


def downgrade_config(cfg: CN, to_version: int) -> CN:
    cfg = cfg.clone()
    assert cfg.VERSION >= to_version, (cfg.VERSION, to_version)
    for k in range(cfg.VERSION, to_version, -1):
        converter = globals()[f"ConverterV{k}"]
        converter.downgrade(cfg)
        cfg.VERSION = k - 1
    return cfg


def guess_version(cfg: CN, filename: str = "") -> int:
    """Infer VERSION of a cfg that doesn't declare one (reference :60-85)."""
    def _has(name: str) -> bool:
        cur = cfg
        for n in name.split("."):
            if n not in cur:
                return False
            cur = cur[n]
        return True

    if _has("MODEL.WEIGHT") or _has("TEST.AUG_ON"):
        return 1
    logger.warning("Config '%s' has no VERSION; assuming current.", filename)
    return _VERSION


def _rename(cfg: CN, old: str, new: str) -> None:
    old_keys, new_keys = old.split("."), new.split(".")
    # partial configs (a loaded YAML before merging) may not carry the key
    cur = cfg
    for k in old_keys:
        if not isinstance(cur, dict) or k not in cur:
            return
        cur = cur[k]

    def _get(key_seq: List[str]):
        cur = cfg
        for k in key_seq:
            cur = cur[k]
        return cur

    def _set(key_seq: List[str], val) -> None:
        cur = cfg
        for k in key_seq[:-1]:
            if k not in cur:
                cur[k] = CN()
            cur = cur[k]
        cur[key_seq[-1]] = val

    def _del(key_seq: List[str]) -> None:
        cur = cfg
        for k in key_seq[:-1]:
            cur = cur[k]
        del cur[key_seq[-1]]
        if len(cur) == 0 and len(key_seq) > 1:
            _del(key_seq[:-1])

    _set(new_keys, _get(old_keys))
    _del(old_keys)


class _RenameConverter:
    RENAME: List[Tuple[str, str]] = []

    @classmethod
    def upgrade(cls, cfg: CN) -> None:
        for old, new in cls.RENAME:
            _rename(cfg, old, new)

    @classmethod
    def downgrade(cls, cfg: CN) -> None:
        for old, new in cls.RENAME[::-1]:
            _rename(cfg, new, old)


class ConverterV1(_RenameConverter):
    RENAME = [("MODEL.RPN_HEAD.NAME", "MODEL.RPN.HEAD_NAME")]


class ConverterV2(_RenameConverter):
    """The V1 -> V2 rename set (reference compat.py:116-229, the keys our
    default tree carries)."""

    RENAME = [
        ("MODEL.WEIGHT", "MODEL.WEIGHTS"),
        ("MODEL.PANOPTIC_FPN.SEMANTIC_LOSS_SCALE", "MODEL.SEM_SEG_HEAD.LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.RPN_LOSS_SCALE", "MODEL.RPN.LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.INSTANCE_LOSS_SCALE", "MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.COMBINE_ON", "MODEL.PANOPTIC_FPN.COMBINE.ENABLED"),
        (
            "MODEL.PANOPTIC_FPN.COMBINE_OVERLAP_THRESHOLD",
            "MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH",
        ),
        (
            "MODEL.PANOPTIC_FPN.COMBINE_STUFF_AREA_LIMIT",
            "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT",
        ),
        (
            "MODEL.PANOPTIC_FPN.COMBINE_INSTANCES_CONFIDENCE_THRESHOLD",
            "MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH",
        ),
        ("MODEL.ROI_HEADS.SCORE_THRESH", "MODEL.ROI_HEADS.SCORE_THRESH_TEST"),
        ("MODEL.ROI_HEADS.NMS", "MODEL.ROI_HEADS.NMS_THRESH_TEST"),
        ("MODEL.RETINANET.INFERENCE_SCORE_THRESHOLD", "MODEL.RETINANET.SCORE_THRESH_TEST"),
        ("MODEL.RETINANET.INFERENCE_TOPK_CANDIDATES", "MODEL.RETINANET.TOPK_CANDIDATES_TEST"),
        ("MODEL.RETINANET.INFERENCE_NMS_THRESHOLD", "MODEL.RETINANET.NMS_THRESH_TEST"),
        ("TEST.AUG_ON", "TEST.AUG.ENABLED"),
        ("TEST.AUG_MIN_SIZES", "TEST.AUG.MIN_SIZES"),
        ("TEST.AUG_MAX_SIZE", "TEST.AUG.MAX_SIZE"),
        ("TEST.AUG_FLIP", "TEST.AUG.FLIP"),
    ]
