"""Command-line entrypoints of the port's driver binaries: the kubelet
plugin (``python -m k8s_dra_driver_tpu_torch.cmd.plugin``, the port's
``tpu-dra-plugin``), the slice-gang controller (``cmd.controller``, the
port's ``tpu-dra-controller``) and the per-claim coordinator daemon
(``cmd.coordinatord``, the port's ``tpu-coordinatord``).  Nothing is
imported here, so ``python -m`` runs each module once."""
