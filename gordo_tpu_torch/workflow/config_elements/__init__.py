from .normalized_config import NormalizedConfig

__all__ = ["NormalizedConfig"]
