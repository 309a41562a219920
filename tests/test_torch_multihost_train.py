"""A gang member's death or wedge fails the port's mesh in-band: the
twin of tests/test_multihost_train.py's
``test_kill_worker_2_mid_step_errors_in_band_not_hang`` for
k8s_dra_driver_tpu_torch, and the wedges its rendezvous deadline
exists for.

Real OS processes stand their gloo group up through the port's
``rendezvous.initialize`` from the driver's env contract (as the JAX
test's ``_spawn_workers`` does), build a ``make_mesh`` mesh and run the
port's ``make_train_step`` on a 2-layer f32 config at
tests/test_torch_parallel.py's widths, printing ``STEP i done`` after
each step.  The workers import torch and the port only, never JAX.
Every case runs with ``TPU_RENDEZVOUS_BARRIER_TIMEOUT_S=5``:

- (a) MeshSpec(dp=2, tp=2): rank 2 is SIGKILLed after ``STEP 0
  done``; every survivor exits nonzero within the JAX test's 240 s;
- (b) the same grid, rank 2 SIGSTOPped instead: a stopped rank keeps
  its sockets open, so only the deadline can fail its peers; every
  survivor exits nonzero within 2 x 5 + 30 s and its stderr names
  ``MeshPeerError`` and an axis;
- (c) MeshSpec(sp=2), the ring forward and backward: rank 1 stopped,
  rank 0 raises from a hop's wait within the same bound;
- (d) MeshSpec(pp=2), the pipeline: one stage stopped, the other
  raises from ``send`` or ``recv`` within the same bound.

The workers wait for a start file before they stand the group up, so
that the short rendezvous deadline does not also time torch's import.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed

import torch_dist

REPO = Path(__file__).parent.parent

#: the rendezvous deadline of every case, seconds
BARRIER_S = 5
#: the JAX test's deadline for a killed rank's survivors
KILL_BOUND_S = 240
#: a wedged rank's survivors: two deadlines (a peer that timed out
#: first, then this rank) and a margin for the processes' exit
WEDGE_BOUND_S = 2 * BARRIER_S + 30
#: seconds to reach the victim's first step (import, rendezvous, step)
START_S = 180

WORKER = r"""
import json, os, sys, time
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import rendezvous
from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh

spec_kw, cfg_kw, go = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    Path(sys.argv[3])
print("READY", flush=True)
deadline = time.monotonic() + 120
while not go.exists() and time.monotonic() < deadline:
    time.sleep(0.02)
spec = rendezvous.initialize(host_override="127.0.0.1", backend="gloo")
mesh = make_mesh(MeshSpec(**spec_kw), device="cpu")
cfg = tt.TransformerConfig(dtype=torch.float32, **cfg_kw)
step, init_state = tt.make_train_step(cfg, device="cpu", mesh=mesh)
params, opt = init_state(torch.Generator().manual_seed(0))
rng = np.random.default_rng(1)
for i in range(10000):
    tokens = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    params, opt, loss = step(params, opt, tokens)
    print(f"STEP {i} done loss {float(loss):.6f}", flush=True)
"""

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=12, d_ff=96, max_seq=64)


def _spawn(tmp_path, n: int, spec: dict, cfg: dict) -> list:
    """``n`` workers of WORKER on one group; returns (process, stdout
    path, stderr path) a rank once every worker has imported torch and
    the port, and starts them together."""
    port = torch_dist.free_port()
    go = tmp_path / "go"
    workers = []
    for w in range(n):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.update({
            "TPU_COORDINATOR_ADDRESS": f"slice-t-w0:{port}",
            "TPU_WORKER_ID": str(w),
            "TPU_NUM_WORKERS": str(n),
            "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(BARRIER_S),
            "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(REPO),
        })
        out, err = tmp_path / f"w{w}.out", tmp_path / f"w{w}.err"
        # a session of its own: a stopped rank in pytest's process
        # group would let the kernel hang the group up (SIGHUP) if it
        # were orphaned
        with open(out, "w") as fo, open(err, "w") as fe:
            proc = subprocess.Popen(
                [sys.executable, "-c", WORKER, json.dumps(spec),
                 json.dumps(dict(BASE, **cfg)), str(go)],
                cwd=REPO, env=env, stdout=fo, stderr=fe,
                start_new_session=True)
        workers.append((proc, out, err))
    deadline = time.monotonic() + START_S
    while not all("READY" in out.read_text() for _, out, _ in workers):
        dead = [w for w, (p, _, _) in enumerate(workers)
                if p.poll() is not None]
        assert not dead and time.monotonic() < deadline, _tails(
            workers, f"workers {dead} exited before starting")
        time.sleep(0.05)
    go.touch()
    return workers


def _tails(workers, what: str) -> str:
    return what + "".join(
        f"\n--- rank {w} (rc {p.poll()}):\n{err.read_text()[-1500:]}"
        for w, (p, _, err) in enumerate(workers))


def _await_step(workers, victim: int) -> None:
    proc, out, _ = workers[victim]
    deadline = time.monotonic() + START_S
    while "STEP 0 done" not in out.read_text():
        assert proc.poll() is None and time.monotonic() < deadline, _tails(
            workers, f"rank {victim} never completed a step")
        time.sleep(0.02)


def _survivors_fail(workers, victim: int, sig: int, bound_s: float
                    ) -> dict:
    """Signal the victim after its first step; every other rank must
    exit nonzero within ``bound_s`` of the signal.  Returns each
    survivor's seconds from the signal to its exit, and its stderr."""
    try:
        _await_step(workers, victim)
        os.kill(workers[victim][0].pid, sig)
        t0 = time.monotonic()
        took, errs = {}, {}
        for w, (proc, _, err) in enumerate(workers):
            if w == victim:
                continue
            try:
                proc.wait(max(0.0, t0 + bound_s - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(_tails(
                    workers, f"rank {w} hung past {bound_s} s instead of "
                    f"erroring after rank {victim} got signal {sig}"))
            took[w] = time.monotonic() - t0
            errs[w] = err.read_text()
            assert proc.returncode != 0, _tails(
                workers, f"rank {w} exited cleanly; the gang's loss must "
                "surface in-band")
        print(f"rank {victim} signal {sig}: survivors' seconds to exit "
              + json.dumps({w: round(s, 2) for w, s in took.items()}))
        return dict(took=took, errs=errs)
    finally:
        for proc, _, _ in workers:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)


def _names_error_and_axis(errs: dict, axes: tuple) -> None:
    for w, err in errs.items():
        assert "MeshPeerError" in err, f"rank {w}:\n{err[-2000:]}"
        assert any(f"mesh axis '{a}'" in err for a in axes), (
            f"rank {w} names no axis of {axes}:\n{err[-2000:]}")
        assert f"deadline of {BARRIER_S} s" in err, err[-2000:]


def test_kill_rank_2_of_dp_tp_grid_errors_in_band_not_hang(tmp_path):
    """(a) The twin of the JAX package's gang-death test."""
    workers = _spawn(tmp_path, 4, dict(dp=2, tp=2), {})
    got = _survivors_fail(workers, 2, signal.SIGKILL, KILL_BOUND_S)
    assert sorted(got["took"]) == [0, 1, 3]
    _names_error_and_axis(got["errs"], ("dp", "tp"))


def test_wedged_rank_2_of_dp_tp_grid_fails_survivors_by_deadline(tmp_path):
    """(b) A stopped rank keeps its sockets open: only the deadline
    fails its peers."""
    workers = _spawn(tmp_path, 4, dict(dp=2, tp=2), {})
    got = _survivors_fail(workers, 2, signal.SIGSTOP, WEDGE_BOUND_S)
    _names_error_and_axis(got["errs"], ("dp", "tp"))


def test_wedged_ring_peer_fails_the_hop_by_deadline(tmp_path):
    """(c) The ring: rank 0 raises from a hop's wait (forward or
    backward) or the ring's gather on the sp axis."""
    workers = _spawn(tmp_path, 2, dict(sp=2), {})
    got = _survivors_fail(workers, 1, signal.SIGSTOP, WEDGE_BOUND_S)
    _names_error_and_axis(got["errs"], ("sp",))
    assert "lost its peers ['sp=1']" in got["errs"][0]


@pytest.mark.parametrize("victim", [0, 1])
def test_wedged_pipeline_stage_fails_send_or_recv_by_deadline(tmp_path,
                                                             victim):
    """(d) The pipeline: the other stage raises from ``send``, ``recv``
    or the broadcast of the last stage's output on the pp axis."""
    workers = _spawn(tmp_path, 2, dict(pp=2), dict(pp_stages=2))
    got = _survivors_fail(workers, victim, signal.SIGSTOP, WEDGE_BOUND_S)
    _names_error_and_axis(got["errs"], ("pp",))
    assert f"'pp={victim}'" in got["errs"][1 - victim]


@pytest.mark.parametrize("world,spec", [(2, dict(sp=2)),
                                        (4, dict(dp=2, tp=2))])
def test_every_mesh_group_carries_the_rendezvous_timeout(tmp_path, world,
                                                         spec):
    """Each axis group ``make_mesh`` makes after ``rendezvous.
    initialize`` has the rendezvous' timeout (torch_dist.PG_TIMEOUT_S),
    and so does the mesh's deadline."""
    got = torch_dist.run_group(torch_dist.timeout_worker, world, spec,
                               out_dir=tmp_path)
    axes = {a for a, n in spec.items() if n > 1}
    for res in got:
        assert res["recorded"] == torch_dist.PG_TIMEOUT_S
        assert res["mesh"] == dict(
            mesh=torch_dist.PG_TIMEOUT_S,
            groups={a: torch_dist.PG_TIMEOUT_S for a in axes})


def test_mesh_over_a_foreign_default_group_takes_torch_default(tmp_path):
    """A default group the port's rendezvous did not stand up leaves the
    mesh's deadline to torch (None), and the rendezvous' record does not
    outlive the group it was made for."""
    import torch.distributed as dist

    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    from k8s_dra_driver_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{torch_dist.free_port()}",
        rank=0, world_size=1)
    try:
        assert rendezvous.group_timeout() is None
        assert make_mesh(device="cpu").timeout is None
    finally:
        dist.destroy_process_group()


def _lone_mesh():
    """A ProcessMesh of MeshSpec(sp=2) at rank 0, with no process group
    behind it: enough to raise through ``_in_band``."""
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, ProcessMesh
    return ProcessMesh(MeshSpec(sp=2), torch.device("cpu"), 0, {},
                       {"sp": [0, 1]})


@pytest.mark.parametrize("error", [
    # the messages gloo gave a survivor here: its peer killed, its peer
    # stopped past the deadline, and the pair closed after that
    RuntimeError("[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc"
                 ":553] Connection closed by peer [127.0.0.1]:4242"),
    RuntimeError("[/pytorch/third_party/gloo/gloo/transport/tcp/"
                 "unbound_buffer.cc:78] Timed out waiting 5000ms for recv "
                 "operation to complete"),
    RuntimeError("Application timeout caused pair closure"),
    torch.distributed.DistNetworkError("connection reset"),
], ids=["closed", "timed-out", "pair-closure", "dist-error"])
def test_a_lost_peer_raises_mesh_peer_error(error):
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshPeerError
    with pytest.raises(MeshPeerError, match=r"axis 'sp'.*\['sp=1'\]") as got:
        with _lone_mesh()._in_band("sp"):
            raise error
    assert got.value.__cause__ is error


@pytest.mark.parametrize("error", [
    # torch's own check of an argument, raised inside a collective
    RuntimeError("input tensor has to be contiguous"),
    # an asynchronous CUDA fault of an earlier kernel, surfacing there
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["argument", "cuda-fault"])
def test_an_error_of_this_rank_passes_unchanged(error):
    with pytest.raises(RuntimeError) as got:
        with _lone_mesh()._in_band("sp"):
            raise error
    assert got.value is error


def test_send_stages_its_tensor_outside_the_in_band_block(monkeypatch):
    """A fault at ``send``'s staging copy (where a CUDA fault of an
    earlier kernel surfaces on the gloo path) is this rank's own, not a
    lost peer, whatever its message says."""
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshPeerError
    mesh = _lone_mesh()
    fault = RuntimeError("[/pytorch/third_party/gloo/gloo/transport/tcp/"
                         "pair.cc:553] looks like gloo, raised by the copy")

    def staging(x, axis):
        raise fault

    monkeypatch.setattr(mesh, "_wire", staging)
    with pytest.raises(RuntimeError) as got:
        mesh.send(torch.ones(2), "sp", 1)
    assert got.value is fault and not isinstance(got.value, MeshPeerError)
