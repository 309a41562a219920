"""Chip and topology discovery: TPU chips and NVIDIA cards (the port's
copy of ``k8s_dra_driver_tpu/discovery``, with an H100 entry and the
NVIDIA path)."""

from .topology import (GENERATIONS, GiB, GenerationSpec, ICICoord, MeshShape,
                       standard_slice_shapes)
from .types import (ChipInfo, DiscoveryBackend, HostTopology, SliceMembership)
from .sysfs import SysfsBackend, host_origin, parse_bounds
from .fake import (H100_PROBE, FakeHost, NvidiaCard, StaticBackend,
                   fake_slice_hosts)
from .mask import MaskedBackend, parse_visible_chips
from .native import NativeBackend, NativeUnavailableError

__all__ = [
    "GENERATIONS", "GiB", "GenerationSpec", "ICICoord", "MeshShape",
    "standard_slice_shapes", "ChipInfo", "DiscoveryBackend", "HostTopology",
    "SliceMembership", "SysfsBackend", "host_origin", "parse_bounds",
    "FakeHost", "H100_PROBE", "NvidiaCard", "StaticBackend",
    "fake_slice_hosts",
    "MaskedBackend", "parse_visible_chips",
    "NativeBackend", "NativeUnavailableError",
]
