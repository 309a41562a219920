"""Command-line entrypoints of the port's driver binaries: the kubelet
plugin (``python -m k8s_dra_driver_tpu_torch.cmd.plugin``, the port's
``tpu-dra-plugin``).  Nothing is imported here, so ``python -m`` runs
the module once."""
