"""API surfaces: Kubernetes resource types + tpu.google.com config API
(the port's copy of ``k8s_dra_driver_tpu/api``; names, kinds and error
messages unchanged)."""

from . import resource
from .config import v1alpha1 as configapi

__all__ = ["resource", "configapi"]
