"""PyTorch + CUDA port of the serving and training paths of
``k8s_dra_driver_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and public names (``models/``, ``ops/``, ``serving_kv/``,
``serving_lora/``, ``serving_disagg/``, ``gateway/``, ``cluster/``,
``parallel/``, ``utils/``) and runs on an NVIDIA Hopper card, with the Pallas kernels
of those paths (flash forward and backward, paged decode) rewritten by
hand in CUDA C++ (``csrc/``).  Entry points default to
``device="cuda"`` and raise when no card is present; tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
