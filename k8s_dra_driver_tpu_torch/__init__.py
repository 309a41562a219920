"""PyTorch + CUDA port of ``k8s_dra_driver_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and public names (``models/``, ``ops/``, ``serving_kv/``,
``serving_lora/``, ``serving_disagg/``, ``gateway/``, ``cluster/``,
``parallel/``, ``utils/``, and the driver's ``discovery/``, ``api/``,
``devicemodel/``, ``allocator/``, ``plugin/``, ``proto/``, ``cmd/``) and
runs on an NVIDIA Hopper card, with the Pallas kernels rewritten by hand
in CUDA C++ (``csrc/``).  Entry points default to ``device="cuda"`` and
raise when no card is present; tests pass ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.  The driver's plugin
imports no ``torch``.
"""

#: the DRA driver's name: its device classes, ResourceSlices and CDI
#: vendor (the JAX package's)
DRIVER_NAME = "tpu.google.com"

# Node label carrying multi-host slice identity, value
# "<sliceId>.<topology>" (the imex-domain label analog, reference
# cmd/nvidia-dra-controller/imex.go:40-46).
SLICE_LABEL = "tpu.google.com/slice"
