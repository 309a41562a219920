"""Attention operators: the dense oracle and the two Hopper kernels
(flash-attention forward, paged decode) with their plain versions.

The probes of ``collectives.py`` are importable from the package, as
the JAX package's are (``from k8s_dra_driver_tpu_torch.ops import
decode_probe``, which the H100 serving demo runs); they load on first
use, so importing a kernel module does not import the probes."""

_PROBES = ("allreduce_bandwidth", "attention_grad_probe", "attention_probe",
           "decode_probe", "dispatch_probe", "matmul_tflops",
           "serving_probe")


def __getattr__(name: str):
    if name in _PROBES:
        from . import collectives
        return getattr(collectives, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
