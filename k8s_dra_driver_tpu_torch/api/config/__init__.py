from . import v1alpha1

__all__ = ["v1alpha1"]
