"""Opaque device-config kinds for tpu.google.com/v1alpha1.

The analog of GpuConfig / MigDeviceConfig / ImexChannelConfig (reference
api/nvidia.com/resource/gpu/v1alpha1/{gpuconfig,migconfig,imexchannelconfig}.go),
re-cut along TPU device types:

- ``TpuChipConfig``      — whole chips and ICI slices (sharing strategy).
- ``TpuPartitionConfig`` — single-core sub-chip partitions (MIG analog);
  only Coordinated/Exclusive sharing makes sense there, mirroring the
  reference's "MPS-only on MIG" stance.
- ``RendezvousConfig``   — multi-host gang rendezvous channels (IMEX
  channel analog): tunes how prepare wires up the slice's coordinator.
"""

from __future__ import annotations

import dataclasses

from .sharing import ConfigError, Sharing, STRATEGY_TIME_SLICING

API_GROUP = "tpu.google.com"
API_VERSION = "tpu.google.com/v1alpha1"


@dataclasses.dataclass
class TpuChipConfig:
    KIND = "TpuChipConfig"

    sharing: Sharing = dataclasses.field(default_factory=Sharing)

    @classmethod
    def default(cls) -> "TpuChipConfig":
        cfg = cls()
        cfg.normalize()
        return cfg

    def normalize(self) -> None:
        self.sharing.normalize()

    def validate(self) -> None:
        self.sharing.validate()


@dataclasses.dataclass
class TpuPartitionConfig:
    KIND = "TpuPartitionConfig"

    sharing: Sharing = dataclasses.field(default_factory=Sharing)

    @classmethod
    def default(cls) -> "TpuPartitionConfig":
        cfg = cls()
        cfg.normalize()
        return cfg

    def normalize(self) -> None:
        self.sharing.normalize()

    def validate(self) -> None:
        self.sharing.validate()
        if self.sharing.strategy == STRATEGY_TIME_SLICING:
            # Partitions are already a spatial share of the chip; stacking
            # time-slicing on top is rejected the way the reference rejects
            # TimeSlicing on MIG (reference sharing.go:103-110).
            raise ConfigError(
                "TimeSlicing is not supported on core partitions; use "
                "Coordinated or Exclusive")


@dataclasses.dataclass
class RendezvousConfig:
    KIND = "RendezvousConfig"

    # Port the slice coordinator listens on inside workload containers.
    port: int = 8471
    # Seconds prepare waits for all gang members to check in.
    barrier_timeout_s: int = 600

    @classmethod
    def default(cls) -> "RendezvousConfig":
        cfg = cls()
        cfg.normalize()
        return cfg

    def normalize(self) -> None:
        if self.port == 0:
            self.port = 8471
        if self.barrier_timeout_s == 0:
            self.barrier_timeout_s = 600

    def validate(self) -> None:
        if not 1 <= self.port <= 65535:
            raise ConfigError(f"rendezvous port {self.port} out of range")
        if self.barrier_timeout_s < 1:
            raise ConfigError("barrierTimeoutSeconds must be >= 1")


TpuConfig = TpuChipConfig | TpuPartitionConfig | RendezvousConfig
