"""Strict decoder for tpu.google.com/v1alpha1 opaque parameters.

The analog of the reference's scheme/strict-JSON Decoder
(reference api/nvidia.com/resource/gpu/v1alpha1/api.go:43-71): opaque
``parameters`` blobs carried in DeviceClass / ResourceClaim configs are
decoded by (apiVersion, kind), unknown fields are rejected, and the
result is a typed config object ready for Normalize/Validate.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .sharing import (ConfigError, CoordinatedSettings, Sharing,
                      TimeSlicingSettings)
from .types import (API_VERSION, RendezvousConfig, TpuChipConfig, TpuConfig,
                    TpuPartitionConfig)

_KINDS: dict[str, type] = {
    TpuChipConfig.KIND: TpuChipConfig,
    TpuPartitionConfig.KIND: TpuPartitionConfig,
    RendezvousConfig.KIND: RendezvousConfig,
}

_FIELD_TYPES: dict[type, dict[str, type]] = {
    TpuChipConfig: {"sharing": Sharing},
    TpuPartitionConfig: {"sharing": Sharing},
    Sharing: {"timeSlicing": TimeSlicingSettings,
              "coordinated": CoordinatedSettings},
}


def _snake(s: str) -> str:
    return "".join("_" + c.lower() if c.isupper() else c for c in s)


def _decode_into(cls: type, data: dict[str, Any], path: str) -> Any:
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: expected object, got {type(data).__name__}")
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    nested = _FIELD_TYPES.get(cls, {})
    for key, value in data.items():
        name = _snake(key)
        if name not in field_names:
            raise ConfigError(
                f"{path}: unknown field {key!r} for {cls.__name__}")
        if key in nested and value is not None:
            value = _decode_into(nested[key], value, f"{path}.{key}")
        kwargs[name] = value
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ConfigError(f"{path}: {e}") from e


def decode(parameters: dict[str, Any]) -> TpuConfig:
    """Decode one opaque ``parameters`` object into a typed config."""
    if not isinstance(parameters, dict):
        raise ConfigError("opaque parameters must be an object")
    api_version = parameters.get("apiVersion", "")
    if api_version != API_VERSION:
        raise ConfigError(
            f"unsupported apiVersion {api_version!r}; want {API_VERSION}")
    kind = parameters.get("kind", "")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ConfigError(
            f"unsupported kind {kind!r}; want one of {sorted(_KINDS)}")
    body = {k: v for k, v in parameters.items()
            if k not in ("apiVersion", "kind")}
    return _decode_into(cls, body, kind)
