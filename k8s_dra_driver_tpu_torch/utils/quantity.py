"""Kubernetes-style resource quantity parsing.

The port's copy of ``k8s_dra_driver_tpu/utils/quantity.py``.

The config API accepts human quantities ("16Gi", "500M") for HBM limits,
mirroring the reference's resource.Quantity handling in per-device memory
limits (reference api/nvidia.com/resource/gpu/v1alpha1/sharing.go:190-209,
unit conversion tested in sharing_test.go).  Only the suffixes that make
sense for byte quantities are supported.
"""

from __future__ import annotations

_SUFFIXES = {
    "": 1,
    "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12, "P": 10 ** 15,
    "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40, "Pi": 2 ** 50,
}


class QuantityError(ValueError):
    pass


def parse_quantity(value: str | int) -> int:
    """Parse a quantity into bytes (an int)."""
    if isinstance(value, int):
        return value
    s = str(value).strip()
    for suffix in sorted(_SUFFIXES, key=len, reverse=True):
        if suffix and s.endswith(suffix):
            num = s[: -len(suffix)]
            break
    else:
        suffix, num = "", s
    try:
        base = float(num) if "." in num else int(num)
    except ValueError as e:
        raise QuantityError(f"invalid quantity {value!r}") from e
    result = base * _SUFFIXES[suffix]
    if result < 0:
        raise QuantityError(f"negative quantity {value!r}")
    return int(result)


def format_quantity(n: int) -> str:
    """Render bytes with the largest clean binary suffix."""
    for suffix in ("Pi", "Ti", "Gi", "Mi", "Ki"):
        unit = _SUFFIXES[suffix]
        if n >= unit and n % unit == 0:
            return f"{n // unit}{suffix}"
    return str(n)
