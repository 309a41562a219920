"""Harness entry points of the port: the counterpart of the repo root's
``__graft_entry__.py``, with its names.

- :func:`entry` — the flagship workload model's forward step (the
  sharded transformer the demo pods run), ``(fn, args)`` field for
  field as the JAX ``entry()`` builds it.
- :func:`dryrun_multichip` — the multichip certification on ``n`` rank
  processes over the port's process mesh: three full training steps
  (loss, gradients, AdamW) of each of the JAX dryrun's configs on
  ``MeshSpec.infer(n)`` (ring attention with capacity MoE and remat,
  Ulysses with grouped-query attention and dense MoE, dropless gmm
  MoE), a pp x dp pipeline, then the serving half: tp-sharded prefill
  and per-row decode must emit the single-process reference's exact
  tokens.

The JAX dryrun pins its subprocess to the CPU backend.  Here the ranks
run where the caller says (``device``, the card by default) and never
fall back: each rank stands up the default group through
``parallel.rendezvous.initialize`` from the driver's env contract,
over gloo (the ranks share a card, which NCCL refuses, or run on the
CPU), and the parent builds the kernel library once before it spawns
them, so the ranks never race ``nvcc``.  Each rank runs in a session of
its own; the parent joins them against a hard deadline, kills what is
left, and raises ``RuntimeError`` with every failed rank's exit code
and the tail of its standard error: a hang becomes a loud error.

Weights come from ``torch.Generator`` seeds and batches from numpy
seeds: every rank, and any reference, rebuilds them exactly
(:func:`dryrun_runs`, :func:`dryrun_params`, :func:`dryrun_tokens`).

Run it (the JAX module's ``__main__``: the forward, then eight ranks):

    python -m k8s_dra_driver_tpu_torch.graft_entry [--device cpu] [--n 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .models.transformer import (TransformerConfig, forward, init_params,
                                 make_train_step, shard_params)
from .parallel.mesh import MeshSpec
from .utils.device import resolve_device

#: the flagship forward of ``entry()`` (the JAX ``__graft_entry__.py``)
FLAGSHIP = dict(vocab=8192, d_model=512, n_layers=4, n_heads=8, d_head=64,
                d_ff=2048, max_seq=256)
FLAGSHIP_TOKENS = (4, 256)

#: train steps a dryrun config takes
DRYRUN_STEPS = 3
#: generator seeds of the training weights and the decode weights, and
#: numpy seeds of the batches and the decode prompts
SEEDS = dict(params=0, tokens=1, decode_params=2, prompts=3)
#: the serving half: rows, prompt tokens, generated tokens
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 8, 6
#: characters of a failed rank's standard error its error keeps
ERR_TAIL = 2000


def entry(device="cuda"):
    """``(fn, (params, tokens))``: the flagship forward step (vocab
    8192, d_model 512, 4 layers of 8 heads of 64, d_ff 2048, max_seq
    256, bf16) on ``tokens`` [4, 256] of zeros, weights from generator
    seed 0 on ``device``."""
    dev = resolve_device(device)
    cfg = TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.zeros(FLAGSHIP_TOKENS, dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


# --------------------------------------------------------------------------
# The dryrun's configurations
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DryrunRun:
    """One training run of the dryrun: its label, config, mesh, and the
    global batch's rows and length."""

    label: str
    cfg: TransformerConfig
    spec: MeshSpec
    batch: int
    seq: int


def dryrun_runs(n_devices: int) -> list[DryrunRun]:
    """The JAX dryrun's training runs on ``n_devices``, field for field:
    the three configs on ``MeshSpec.infer(n)`` and, when ``n`` divides
    by 2, the pipeline over pp = 4 (or 2) x dp."""
    spec = MeshSpec.infer(n_devices)
    heads = max(4, spec.tp * 2) * max(1, spec.sp)
    common = dict(vocab=128, d_model=64, n_layers=2, d_head=8, d_ff=128,
                  n_experts=max(4, spec.ep * 2), top_k=2,
                  max_seq=8 * spec.sp, dtype=torch.float32)
    configs = [
        ("ring, capacity MoE, remat", TransformerConfig(
            n_heads=max(4, spec.tp * 2), moe_dispatch="capacity",
            remat=True, **common)),
        ("Ulysses, GQA, dense MoE", TransformerConfig(
            n_heads=heads, seq_parallel="ulysses",
            n_kv_heads=max(1, spec.tp) * max(1, spec.sp), **common)),
        ("ring, dropless gmm MoE", TransformerConfig(
            n_heads=max(4, spec.tp * 2), moe_dispatch="gmm", **common)),
    ]
    runs = [DryrunRun(label, cfg, spec, max(2, spec.dp * spec.ep) * 2,
                      8 * spec.sp) for label, cfg in configs]
    pp = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    if pp > 1:
        dp = n_devices // pp
        cfg = TransformerConfig(
            vocab=128, d_model=64, n_layers=pp, n_heads=4, d_head=8,
            d_ff=128, max_seq=16, dtype=torch.float32, pp_stages=pp,
            remat=True)
        runs.append(DryrunRun(f"pipeline pp={pp} x dp={dp}", cfg,
                              MeshSpec(dp=dp, pp=pp), 2 * pp * max(2, dp),
                              16))
    return runs


def decode_config(spec: MeshSpec) -> TransformerConfig:
    """The serving half's model: GQA with ``max(2, tp)`` KV heads."""
    return TransformerConfig(
        vocab=128, d_model=64, n_layers=2, n_heads=max(4, spec.tp * 2),
        d_head=8, d_ff=128, n_kv_heads=max(2, spec.tp), max_seq=32,
        dtype=torch.float32)


def dryrun_params(cfg: TransformerConfig, device="cpu", seed=None):
    """Whole weights of a dryrun config (generator seed
    ``SEEDS["params"]`` unless given), as every rank draws them."""
    seed = SEEDS["params"] if seed is None else seed
    return init_params(cfg, torch.Generator().manual_seed(seed),
                       device=device)


def dryrun_tokens(cfg: TransformerConfig, batch: int, seq: int,
                  seed=None) -> np.ndarray:
    """A run's global batch [batch, seq] (numpy seed ``SEEDS["tokens"]``
    unless given)."""
    seed = SEEDS["tokens"] if seed is None else seed
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))


# --------------------------------------------------------------------------
# A rank
# --------------------------------------------------------------------------

def _launches() -> dict:
    """The kernels' launch counters: K1 (normalized entry and block
    entry), K3, K4, K5 and K6, each with its tensor-core share."""
    from .ops import flash_attention as fa
    from .ops import gmm as gm
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
            "flash_fwd_block": fa.block_launches,
            "flash_fwd_block_tc": fa.block_tc_launches,
            "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dq_tc": fa.dq_tc_launches,
            "flash_bwd_dkv": fa.dkv_launches,
            "flash_bwd_dkv_tc": fa.dkv_tc_launches,
            "gmm": gm.launches["gmm"], "gmm_tc": gm.tc_launches,
            "gmm_dw": gm.launches["gmm_dw"],
            "gmm_dw_tc": gm.dw_tc_launches}


def _since(before: dict) -> dict:
    """The launches since ``before`` (a :func:`_launches` snapshot)."""
    return {k: v - before[k] for k, v in _launches().items()}


def _dryrun_multichip_impl(n_devices: int, device="cuda") -> dict:
    """This rank's part of the dryrun, inside an initialized default
    group of ``n_devices`` ranks: :data:`DRYRUN_STEPS` steps of every
    run of :func:`dryrun_runs`, each loss finite and the last below the
    first, then :func:`_dryrun_decode`.  Returns this rank's report:
    coordinates, each run's losses and launches, the decode's."""
    from .parallel.mesh import make_mesh
    dev = resolve_device(device)
    runs = dryrun_runs(n_devices)
    meshes = {}
    for run in runs:      # every rank makes the meshes in one order
        if run.spec not in meshes:
            meshes[run.spec] = make_mesh(run.spec, device=dev)
    spec = runs[0].spec                 # MeshSpec.infer(n_devices)
    report = {"rank": meshes[spec].rank, "spec": spec.axis_sizes(),
              "runs": []}
    for run in runs:
        mesh = meshes[run.spec]
        step, init_state = make_train_step(run.cfg, dev, mesh=mesh)
        params, opt = init_state(
            torch.Generator().manual_seed(SEEDS["params"]))
        tokens = dryrun_tokens(run.cfg, run.batch, run.seq)
        before, losses = _launches(), []
        t0 = time.perf_counter()
        for _ in range(DRYRUN_STEPS):
            params, opt, loss = step(params, opt, tokens)
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"{run.label}: non-finite loss {loss}")
            losses.append(loss)
        if not losses[-1] < losses[0]:
            raise AssertionError(
                f"{run.label}: loss did not decrease over {DRYRUN_STEPS} "
                f"steps: {losses}")
        report["runs"].append(dict(
            label=run.label, coords=mesh.coords, losses=losses,
            launches=_since(before), seconds=time.perf_counter() - t0))
        del params, opt
    report["decode"] = _dryrun_decode(spec, meshes[spec], dev)
    return report


def _dryrun_decode(spec: MeshSpec, mesh, device) -> dict:
    """The serving half on ``mesh``: the decode config's weights cut by
    ``shard_params``, prefill and per-row decode steps of
    ``DECODE_NEW`` greedy tokens under ``mesh=``, against
    ``greedy_generate`` of the whole weights in this process alone.
    Raises unless every token is equal; returns the tokens and the
    launches of the sharded pass."""
    from .models.decode import (decode_step_rows, greedy_generate,
                                init_cache, prefill)
    cfg = decode_config(spec)
    params = dryrun_params(cfg, device, seed=SEEDS["decode_params"])
    prompts = torch.from_numpy(np.random.default_rng(SEEDS["prompts"])
                               .integers(0, cfg.vocab, (DECODE_BATCH,
                                                        DECODE_PROMPT))
                               ).to(device)
    want = greedy_generate(params, prompts, cfg, DECODE_NEW)[:, DECODE_PROMPT:]
    sharded = shard_params(params, cfg, mesh)
    before = _launches()
    with torch.no_grad():
        cache = init_cache(cfg, DECODE_BATCH, cfg.max_seq, device=device,
                           mesh=mesh)
        logits, cache = prefill(sharded, prompts, cfg, cache, mesh=mesh)
        tok = logits[:, -1].argmax(dim=-1)
        pos = torch.full((DECODE_BATCH,), DECODE_PROMPT, device=device)
        toks = [tok]
        for _ in range(DECODE_NEW - 1):
            lg, cache = decode_step_rows(sharded, tok[:, None], cfg, cache,
                                         pos, mesh=mesh)
            tok, pos = lg.argmax(dim=-1), pos + 1
            toks.append(tok)
    got = torch.stack(toks, dim=1)
    if not torch.equal(got, want):
        raise AssertionError(
            f"tp-sharded decode diverged from the single-process "
            f"reference:\n{got.tolist()}\nvs\n{want.tolist()}")
    return dict(coords=mesh.coords, tokens=got.tolist(),
                launches=_since(before))


def _rank_main(n_devices: int, device: str, out_dir: str) -> None:
    """A rank process: the group from the env contract (gloo), the
    dryrun, its report written as ``rank<r>.json`` in ``out_dir``."""
    import torch.distributed as dist

    from .parallel import rendezvous
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    spec = rendezvous.initialize(rendezvous.spec_from_env(), backend="gloo")
    try:
        report = _dryrun_multichip_impl(n_devices, device)
    finally:
        dist.destroy_process_group()
    path = Path(out_dir) / f"rank{spec.worker_id}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(report))
    tmp.rename(path)


# --------------------------------------------------------------------------
# The parent
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(rank: int, n_devices: int, device: str, out_dir: str
               ) -> list[str]:
    """The command of rank ``rank`` (its id comes from the env)."""
    return [sys.executable, "-m", "k8s_dra_driver_tpu_torch.graft_entry",
            "--device", device, "--n", str(n_devices), "--rank-out",
            out_dir]


def _stop(proc: subprocess.Popen) -> None:
    """Kill ``proc``'s session if it still runs, and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait(timeout=30)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 420.0) -> list[dict]:
    """Run the dryrun on ``n_devices`` rank processes on ``device`` and
    return their reports in rank order (:func:`_dryrun_multichip_impl`).

    The ranks form their group over gloo from the env contract; their
    groups' deadline is half of ``timeout_s``, so a lost peer fails its
    survivors in-band (``MeshPeerError``) before the parent's own
    deadline.  The parent polls them: once a rank fails, or
    ``timeout_s`` passes, every rank still running is killed (its whole
    session) and ``RuntimeError`` names each failed rank's exit code
    (or the deadline) and the tail of its standard error."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from .ops import _build
        _build.library()            # built once, here: no rank runs nvcc
    root = Path(__file__).resolve().parents[1]
    out = Path(tempfile.mkdtemp(prefix="dryrun-multichip-"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(n_devices):
            rank_env = dict(
                env, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                TPU_WORKER_ID=str(rank), TPU_NUM_WORKERS=str(n_devices),
                TPU_RENDEZVOUS_BARRIER_TIMEOUT_S=str(
                    max(1, int(timeout_s / 2))))
            with open(out / f"rank{rank}.out", "w") as fo, \
                    open(out / f"rank{rank}.err", "w") as fe:
                procs.append(subprocess.Popen(
                    _rank_argv(rank, n_devices, dev.type, str(out)),
                    cwd=root, env=rank_env, stdout=fo, stderr=fe,
                    stdin=subprocess.DEVNULL, start_new_session=True))
        t0 = time.monotonic()
        while time.monotonic() < t0 + timeout_s:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.2)
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        stopped = time.monotonic() - t0
    finally:
        for p in procs:
            _stop(p)
    try:
        failed = []
        for rank, p in enumerate(procs):
            if rank in late or p.returncode != 0 or not (
                    out / f"rank{rank}.json").exists():
                why = (f"still running {stopped:.1f} s after the start "
                       f"(deadline {timeout_s:g} s), killed" if rank in late
                       else f"rc={p.returncode}")
                tail = (out / f"rank{rank}.err").read_text()[-ERR_TAIL:]
                failed.append(f"rank {rank} ({why}):\n{tail}")
        if failed:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) failed on {len(failed)} of "
                f"{n_devices} ranks:\n" + "\n".join(failed))
        return [json.loads((out / f"rank{r}.json").read_text())
                for r in range(n_devices)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=8)
    parser.add_argument("--rank-out", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_out is not None:
        _rank_main(args.n, args.device, args.rank_out)
        return
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(args.n, device=args.device)
    print(f"dryrun_multichip({args.n}): ok", flush=True)


__all__ = ["DryrunRun", "decode_config", "dryrun_multichip", "dryrun_params",
           "dryrun_runs", "dryrun_tokens", "entry"]


if __name__ == "__main__":
    main()
