"""Visible-chip masking: the nvkind per-worker partitioning analog.

The port's copy of ``k8s_dra_driver_tpu/discovery/mask.py``: the
plugin's ``--visible-chips`` filter, for accel-class chips and NVIDIA
cards alike (a card's index is its device minor).

The reference partitions GPUs between kind workers by masking the
device set each plugin may enumerate (reference
deployments/helm/k8s-dra-driver/values.yaml:40-51 +
templates/kubeletplugin.yaml:58-67, driven by nvkind's per-worker
params files); VERDICT missing #3 called out that the TPU chart had no
analog.  :class:`MaskedBackend` is that knob at the discovery
boundary: it wraps any real backend and filters BOTH surfaces —
``enumerate()`` (the chips the plugin publishes) and ``health()`` (a
masked-out chip's failures are not this plugin's business) — so
everything downstream (device model, ResourceSlices, CDI, the health
monitor) behaves as if the host only had the visible chips.

Wired as ``--visible-chips`` on the plugin binary (helm:
``kubeletPlugin.visibleChips``).  The value is either a comma list of
host-local chip indices or ``@<path>`` naming a file that carries the
list — the per-worker form: each kind worker's mounted host tree
ships its own mask file, so ONE chart value gives every worker a
different mask, exactly the reference's params-file pattern
(demo/clusters/kind/create-cluster.sh writes the files for the gang
config).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from .types import DiscoveryBackend, HostTopology


def parse_visible_chips(value: str,
                        driver_root: str = "/") -> frozenset[int] | None:
    """``--visible-chips`` value -> index set (None = no masking).

    ``@<path>`` reads the comma list from a file, resolved under
    ``driver_root`` the way every other discovery probe is (the mask
    file rides the same host mount as the sysfs tree it masks).
    """
    value = (value or "").strip()
    if not value:
        return None
    if value.startswith("@"):
        path = Path(value[1:])
        rooted = Path(driver_root) / path.relative_to("/") \
            if path.is_absolute() else Path(driver_root) / path
        value = rooted.read_text().strip()
        if not value:
            return None
    try:
        return frozenset(int(x) for x in value.split(",") if x.strip())
    except ValueError as e:
        raise ValueError(
            f"--visible-chips wants a comma list of chip indices or "
            f"@<file>, got {value!r}") from e


class MaskedBackend(DiscoveryBackend):
    """Filter a discovery backend to a visible-chip index set.

    Unknown indices fail fast at construction-time enumeration: a mask
    naming a chip the host does not have is a deployment error
    (mis-rendered per-worker file), not a reduced set to serve
    quietly.
    """

    def __init__(self, inner: DiscoveryBackend,
                 visible: frozenset[int]):
        if not visible:
            raise ValueError("visible-chip mask must name >= 1 chip")
        self.inner = inner
        self.visible = frozenset(visible)

    def enumerate(self) -> HostTopology:
        topo = self.inner.enumerate()
        have = {c.index for c in topo.chips}
        unknown = self.visible - have
        if unknown:
            raise ValueError(
                f"visible-chips mask names chip(s) {sorted(unknown)} "
                f"not on this host (has {sorted(have)})")
        return dataclasses.replace(
            topo, chips=tuple(c for c in topo.chips
                              if c.index in self.visible))

    def health(self, expected=None) -> dict[int, str]:
        """The inner backend still judges the FULL host (surprise
        removal needs the full expected set), but only visible chips'
        failures surface — a masked-out chip is some other worker's
        (or nobody's) problem."""
        return {idx: reason
                for idx, reason in self.inner.health(
                    expected=expected).items()
                if idx in self.visible}


__all__ = ["MaskedBackend", "parse_visible_chips"]
