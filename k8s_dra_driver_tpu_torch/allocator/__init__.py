"""In-repo structured-parameters allocator (kube-scheduler stand-in;
the port's copy of ``k8s_dra_driver_tpu/allocator``)."""

from .allocator import AllocationError, Allocator
from .cel import CELError, evaluate, matches_selectors
from .scheduler import allocate_claim, deallocate_claim

__all__ = ["AllocationError", "Allocator", "CELError", "allocate_claim",
           "deallocate_claim", "evaluate", "matches_selectors"]
