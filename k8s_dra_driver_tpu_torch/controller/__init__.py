"""Cluster controller: multi-host slice gangs + rendezvous channels (the
port of ``k8s_dra_driver_tpu/controller/``; no torch)."""

from .slices import (CHANNELS_PER_SLICE, ChannelOffsets, SLICE_LABEL,
                     SliceGangController, TOTAL_CHANNELS, parse_slice_label,
                     slice_label_value)

__all__ = [
    "CHANNELS_PER_SLICE", "ChannelOffsets", "SLICE_LABEL",
    "SliceGangController", "TOTAL_CHANNELS", "parse_slice_label",
    "slice_label_value",
]
