"""Config system: yacs-compatible CfgNode + the detectron2 default tree.

The same keys as the JAX package's ``config`` (a copy, so the port imports
nothing of that package): ``get_cfg()`` returns the defaults, YAML files
merge through ``CfgNode.merge_from_file`` and "KEY VALUE" pairs through
``merge_from_list``.
"""

from .cfgnode import CfgNode
from .compat import downgrade_config, upgrade_config
from .defaults import build_default_cfg

__all__ = ["CfgNode", "downgrade_config", "get_cfg", "upgrade_config"]


def get_cfg() -> CfgNode:
    """Return a fresh copy of the default config tree."""
    return build_default_cfg()
