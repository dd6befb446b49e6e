"""The model zoo's config lookup (``model_zoo.get``, ``get_config``, ...)."""

from .model_zoo import get, get_checkpoint_url, get_config, get_config_file

__all__ = ["get", "get_checkpoint_url", "get_config", "get_config_file"]
