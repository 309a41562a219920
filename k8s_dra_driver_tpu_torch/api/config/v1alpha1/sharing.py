"""Sharing strategies for TPU devices.

TPU-native rethink of the reference's sharing config
(reference api/nvidia.com/resource/gpu/v1alpha1/sharing.go):

- ``Exclusive``     — default; one claim owns the chip.
- ``TimeSlicing``   — cooperative time-multiplexing between claims; the
  interval class maps to a preemption-quantum hint that the node's
  runtime coordinator enforces (there is no nvidia-smi analog on TPU;
  the knob travels as CDI env + a policy file, see plugin/sharing.py).
- ``Coordinated``   — spatial sharing arbitrated by a per-chip/slice
  coordinator daemon (the MPS-control-daemon analog): ``dutyCyclePercent``
  plays the role of MPS active-thread percentage, ``perDeviceHbmLimits``
  the role of pinned-device-memory limits
  (reference sharing.go:93-117,183-229).
"""

from __future__ import annotations

import dataclasses

from ....utils.quantity import QuantityError, parse_quantity

STRATEGY_EXCLUSIVE = "Exclusive"
STRATEGY_TIME_SLICING = "TimeSlicing"
STRATEGY_COORDINATED = "Coordinated"

INTERVAL_DEFAULT = "Default"
INTERVAL_SHORT = "Short"
INTERVAL_MEDIUM = "Medium"
INTERVAL_LONG = "Long"

# Preemption quanta (ms) each interval class maps to; the TPU analog of
# the reference's timeslice→ms mapping (sharing.go:167-180).
_INTERVAL_MS = {
    INTERVAL_DEFAULT: 0,      # runtime default
    INTERVAL_SHORT: 1,
    INTERVAL_MEDIUM: 5,
    INTERVAL_LONG: 20,
}


class ConfigError(ValueError):
    """Invalid opaque configuration."""


class InvalidDeviceSelectorError(ConfigError):
    """A per-device limit key selects no known device."""


class InvalidLimitError(ConfigError):
    """A per-device limit value is malformed."""


@dataclasses.dataclass
class TimeSlicingSettings:
    interval: str = INTERVAL_DEFAULT

    def normalize(self) -> None:
        if not self.interval:
            self.interval = INTERVAL_DEFAULT

    def validate(self) -> None:
        if self.interval not in _INTERVAL_MS:
            raise ConfigError(
                f"unknown time-slice interval {self.interval!r}; "
                f"want one of {sorted(_INTERVAL_MS)}")

    @property
    def interval_ms(self) -> int:
        return _INTERVAL_MS[self.interval]


@dataclasses.dataclass
class CoordinatedSettings:
    duty_cycle_percent: int = 100
    # Keys: "default", a chip index ("0"), or a chip UUID.  Values:
    # quantity strings ("8Gi") or ints (bytes).
    per_device_hbm_limits: dict[str, str | int] = dataclasses.field(
        default_factory=dict)
    # Daemon-side enforcement (claim-driven, not just daemon flags):
    # SIGSTOP/SIGCONT registered workers to the schedule and act on
    # violations (HBM overage, unregistered /dev/accel* holders).
    # The rendered coordinator pod runs hostPID+privileged either
    # way (the scan needs it); these choose what it DOES.
    enforce: bool = False
    # "report" records violations in status.json; "terminate"
    # additionally SIGTERMs violators when enforcing.
    violation_action: str = "report"

    def normalize(self) -> None:
        if self.duty_cycle_percent == 0:
            self.duty_cycle_percent = 100
        if not self.violation_action:
            self.violation_action = "report"

    def validate(self) -> None:
        if not 1 <= self.duty_cycle_percent <= 100:
            raise ConfigError(
                f"dutyCyclePercent must be in [1,100], got "
                f"{self.duty_cycle_percent}")
        if not isinstance(self.enforce, bool):
            # a truthy string like "false" must not silently enable
            # SIGSTOP/SIGTERM enforcement — the opposite of intent
            raise ConfigError(
                f"enforce must be a JSON boolean, got "
                f"{self.enforce!r}")
        if self.violation_action not in ("report", "terminate"):
            raise ConfigError(
                f"violationAction must be 'report' or 'terminate', "
                f"got {self.violation_action!r}")
        for key, val in self.per_device_hbm_limits.items():
            try:
                parse_quantity(val)
            except QuantityError as e:
                raise InvalidLimitError(
                    f"hbm limit for {key!r}: {e}") from e

    def resolved_hbm_limits(
            self, uuids: list[str],
            uuid_by_index: dict[int, str] | None = None) -> dict[str, int]:
        """Resolve default/index/uuid keys into a per-UUID byte map.

        The analog of MpsPerDevicePinnedMemoryLimit.Normalize (reference
        sharing.go:190-209): explicit UUID keys beat index keys beat the
        "default" key; unknown selectors are errors.
        """
        uuid_by_index = uuid_by_index or dict(enumerate(uuids))
        out: dict[str, int] = {}
        default = self.per_device_hbm_limits.get("default")
        if default is not None:
            for u in uuids:
                out[u] = parse_quantity(default)
        for key, val in self.per_device_hbm_limits.items():
            if key == "default":
                continue
            if key.isdigit():
                idx = int(key)
                if idx not in uuid_by_index or uuid_by_index[idx] not in uuids:
                    raise InvalidDeviceSelectorError(
                        f"hbm limit index {idx} matches no allocated device")
                out[uuid_by_index[idx]] = parse_quantity(val)
            elif key in uuids:
                out[key] = parse_quantity(val)
            else:
                raise InvalidDeviceSelectorError(
                    f"hbm limit selector {key!r} matches no allocated device")
        return out


@dataclasses.dataclass
class Sharing:
    strategy: str = STRATEGY_EXCLUSIVE
    time_slicing: TimeSlicingSettings | None = None
    coordinated: CoordinatedSettings | None = None

    def normalize(self) -> None:
        if not self.strategy:
            self.strategy = STRATEGY_EXCLUSIVE
        if self.strategy == STRATEGY_TIME_SLICING and self.time_slicing is None:
            self.time_slicing = TimeSlicingSettings()
        if self.strategy == STRATEGY_COORDINATED and self.coordinated is None:
            self.coordinated = CoordinatedSettings()
        if self.time_slicing:
            self.time_slicing.normalize()
        if self.coordinated:
            self.coordinated.normalize()

    def validate(self) -> None:
        known = (STRATEGY_EXCLUSIVE, STRATEGY_TIME_SLICING,
                 STRATEGY_COORDINATED)
        if self.strategy not in known:
            raise ConfigError(
                f"unknown sharing strategy {self.strategy!r}; want one of "
                f"{known}")
        if self.strategy != STRATEGY_TIME_SLICING and \
                self.time_slicing is not None:
            raise ConfigError(
                "timeSlicing settings given but strategy is "
                f"{self.strategy}")
        if self.strategy != STRATEGY_COORDINATED and \
                self.coordinated is not None:
            raise ConfigError(
                f"coordinated settings given but strategy is {self.strategy}")
        if self.time_slicing:
            self.time_slicing.validate()
        if self.coordinated:
            self.coordinated.validate()

    @property
    def is_shared(self) -> bool:
        return self.strategy != STRATEGY_EXCLUSIVE
