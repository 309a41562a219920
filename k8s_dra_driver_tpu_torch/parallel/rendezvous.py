"""Workload-side consumer of the gang rendezvous contract, for
``torch.distributed``.

The port of ``k8s_dra_driver_tpu/parallel/rendezvous.py``.  A gang
prepare injects the same environment as for the JAX package (the
driver's contract keeps its names):

- ``TPU_COORDINATOR_ADDRESS``  host:port of the gang coordinator
- ``TPU_WORKER_ID``            this process's rank in the gang
- ``TPU_NUM_WORKERS``          gang size (explicit; hostnames may be
                               empty when an external coordinator is
                               configured)
- ``TPU_WORKER_HOSTNAMES``     comma list, informational
- ``TPU_RENDEZVOUS_BARRIER_TIMEOUT_S``  init deadline
- ``TPU_RENDEZVOUS_CHANNEL``   allocated channel id, informational

:func:`initialize` parses that contract and stands up the default
process group with ``init_process_group(backend, init_method=
"tcp://host:port", rank, world_size, timeout)``: rank 0 serves the
store at the coordinator address.  The backend is the caller's choice,
``"nccl"`` by default: NCCL with one card per rank; gloo where ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
:func:`gang_psum` is the liveness check: every worker contributes a
value and all must observe the same global sum, which only happens if
the collective ran.

``python -m k8s_dra_driver_tpu_torch.parallel.rendezvous`` runs the
contract, the psum and prints one JSON line, as the JAX module's
``main`` does.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import torch
import torch.distributed as dist


class ContractError(ValueError):
    """The injected rendezvous env is missing or inconsistent, or the
    gang never formed by its deadline."""


#: (default group, timeout) of the last :func:`initialize`; the timeout
#: holds while that group is still the world (:func:`group_timeout`)
_recorded: tuple | None = None


@dataclasses.dataclass(frozen=True)
class RendezvousSpec:
    coordinator_address: str          # host:port
    worker_id: int
    num_workers: int
    barrier_timeout_s: int = 600
    channel: int | None = None
    topology: str = ""


def spec_from_env(env: dict | None = None) -> RendezvousSpec:
    """Parse the driver-injected contract; fail fast on gaps."""
    env = dict(os.environ) if env is None else env
    addr = env.get("TPU_COORDINATOR_ADDRESS", "")
    if ":" not in addr:
        raise ContractError(
            f"TPU_COORDINATOR_ADDRESS missing or not host:port: {addr!r}")
    try:
        worker_id = int(env["TPU_WORKER_ID"])
    except (KeyError, ValueError) as e:
        raise ContractError(f"TPU_WORKER_ID invalid: {e}") from e
    n_raw = env.get("TPU_NUM_WORKERS", "")
    if n_raw:
        try:
            num_workers = int(n_raw)
        except ValueError as e:
            raise ContractError(f"TPU_NUM_WORKERS invalid: {e}") from e
    else:
        hosts = [h for h in
                 env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
        if not hosts:
            raise ContractError(
                "neither TPU_NUM_WORKERS nor TPU_WORKER_HOSTNAMES set")
        num_workers = len(hosts)
    if not 0 <= worker_id < num_workers:
        raise ContractError(
            f"worker_id {worker_id} out of range for {num_workers}")
    try:
        channel = env.get("TPU_RENDEZVOUS_CHANNEL")
        return RendezvousSpec(
            coordinator_address=addr,
            worker_id=worker_id,
            num_workers=num_workers,
            barrier_timeout_s=int(
                env.get("TPU_RENDEZVOUS_BARRIER_TIMEOUT_S", "600")
                or 600),
            channel=int(channel) if channel else None,
            topology=env.get("TPU_TOPOLOGY", ""))
    except ValueError as e:
        raise ContractError(f"rendezvous env invalid: {e}") from e


def initialize(spec: RendezvousSpec | None = None, *,
               backend: str = "nccl",
               host_override: str | None = None) -> RendezvousSpec:
    """``init_process_group`` from the injected contract.

    ``backend`` is the caller's explicit choice: ``"nccl"`` (the
    default) with one card per rank, ``"gloo"`` where ranks share a
    card or run on the CPU.  ``host_override`` replaces the host part of
    the coordinator address, for test beds where gang worker hostnames
    are not resolvable.

    ``TPU_RENDEZVOUS_BARRIER_TIMEOUT_S`` is the default group's timeout:
    it bounds the store's rendezvous (a coordinator that never comes
    up, peers that never join) and every later collective on the
    default group.  :func:`group_timeout` hands it on, and
    ``parallel.mesh.make_mesh`` gives it to every axis group it makes,
    so each collective and exchange of the mesh is bounded by it too.
    A rendezvous that fails raises :class:`ContractError` with the spec
    echoed."""
    global _recorded
    spec = spec or spec_from_env()
    host, _, port = spec.coordinator_address.rpartition(":")
    host = host_override or host
    timeout = datetime.timedelta(seconds=spec.barrier_timeout_s)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                                rank=spec.worker_id,
                                world_size=spec.num_workers,
                                timeout=timeout)
    except (RuntimeError, ValueError, OSError) as e:
        raise ContractError(
            f"rendezvous failed within {spec.barrier_timeout_s}s: gang "
            f"never formed at coordinator {host}:{port} (spec: worker "
            f"{spec.worker_id}/{spec.num_workers}, channel {spec.channel}, "
            f"topology {spec.topology!r}): {e}") from e
    _recorded = (dist.group.WORLD, timeout)
    return spec


def group_timeout() -> datetime.timedelta | None:
    """The timeout :func:`initialize` gave the default group, while that
    group is still the world; None when the world was stood up another
    way (or torn down since)."""
    if (_recorded is None or not dist.is_initialized()
            or dist.group.WORLD is not _recorded[0]):
        return None
    return _recorded[1]


def gang_psum(value: float) -> float:
    """All-reduce of one scalar over the default group; every worker
    returns the same total, the sum of all workers' values.  Under NCCL
    the scalar lives on the current card (set it first), under gloo on
    the host."""
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    x = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(x)
    return float(x.item())


def main(argv: list[str] | None = None) -> None:
    """Consume the contract, run the liveness psum, print one JSON
    line: the runnable proof a prepared gang pod would execute."""
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host-override", default=None)
    parser.add_argument("--backend", default="nccl",
                        help="nccl (one card per rank) or gloo")
    parser.add_argument("--contribute", type=float, default=None,
                        help="value this worker adds (default: rank+1)")
    args = parser.parse_args(argv)
    spec = spec_from_env()
    if args.backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    initialize(spec, backend=args.backend,
               host_override=args.host_override)
    value = (args.contribute if args.contribute is not None
             else float(spec.worker_id + 1))
    try:
        total = gang_psum(value)
        print(json.dumps({
            "worker_id": spec.worker_id,
            "num_workers": spec.num_workers,
            "world_size": dist.get_world_size(),
            "backend": dist.get_backend(),
            "contributed": value,
            "psum": total,
        }), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
