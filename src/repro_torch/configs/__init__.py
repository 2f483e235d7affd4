"""Architecture configs of the port. The other ten configs of the JAX
package arrive with their families."""
from .base import ArchConfig
from .registry import get_config, list_archs

# Import for registration side effects.
from . import h2o_danube_1_8b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs"]
