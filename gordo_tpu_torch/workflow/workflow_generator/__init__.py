from .workflow_generator import get_dict_from_yaml

__all__ = ["get_dict_from_yaml"]
