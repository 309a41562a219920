"""tpu.google.com/v1alpha1 opaque device-configuration API (the port's
copy of ``k8s_dra_driver_tpu/api/config/v1alpha1``)."""

from .sharing import (ConfigError, CoordinatedSettings,
                      InvalidDeviceSelectorError, InvalidLimitError, Sharing,
                      TimeSlicingSettings, STRATEGY_COORDINATED,
                      STRATEGY_EXCLUSIVE, STRATEGY_TIME_SLICING,
                      INTERVAL_DEFAULT, INTERVAL_LONG, INTERVAL_MEDIUM,
                      INTERVAL_SHORT)
from .types import (API_GROUP, API_VERSION, RendezvousConfig, TpuChipConfig,
                    TpuConfig, TpuPartitionConfig)
from .decoder import decode

__all__ = [
    "API_GROUP", "API_VERSION", "ConfigError", "CoordinatedSettings",
    "InvalidDeviceSelectorError", "InvalidLimitError", "RendezvousConfig",
    "Sharing", "TimeSlicingSettings", "TpuChipConfig", "TpuConfig",
    "TpuPartitionConfig", "decode",
    "STRATEGY_COORDINATED", "STRATEGY_EXCLUSIVE", "STRATEGY_TIME_SLICING",
    "INTERVAL_DEFAULT", "INTERVAL_LONG", "INTERVAL_MEDIUM", "INTERVAL_SHORT",
]
