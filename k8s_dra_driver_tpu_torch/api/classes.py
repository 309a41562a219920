"""Standard DeviceClass definitions for tpu.google.com.

The port's copy of ``k8s_dra_driver_tpu/api/classes.py``: the driver
keeps its name, ``tpu.google.com``, on every card; an H100 is told apart
by its ``generation`` and ``productName`` attributes.

The analog of the reference's three DeviceClasses with CEL selectors
(reference deployments/helm/k8s-dra-driver/templates/
deviceclass-{gpu,mig,imex}.yaml): one class per device kind, selecting
on driver + published ``type`` attribute.
"""

from __future__ import annotations

from . import resource


def _cls(name: str, kind: str) -> resource.DeviceClass:
    return resource.DeviceClass(
        metadata=resource.ObjectMeta(name=name),
        selectors=[resource.DeviceSelector(
            cel=f'device.driver == "tpu.google.com" && '
                f'device.attributes["type"] == "{kind}"')])


def standard_device_classes() -> dict[str, resource.DeviceClass]:
    return {
        "tpu.google.com": _cls("tpu.google.com", "chip"),
        "tpu-core.google.com": _cls("tpu-core.google.com", "core"),
        "tpu-slice.google.com": _cls("tpu-slice.google.com", "slice"),
        "tpu-rendezvous.google.com": _cls("tpu-rendezvous.google.com",
                                          "rendezvous"),
        "tpu-podslice.google.com": _cls("tpu-podslice.google.com",
                                        "podslice"),
    }
