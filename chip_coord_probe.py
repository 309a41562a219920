"""Read-only probes of what the coordination layer relies on, on a
machine with one NVIDIA card:

    python3 chip_coord_probe.py

Prints, one line each: the card and its power limit, the torch and CUDA
versions; the ``/dev/nvidia*`` nodes and ``nvidia-smi -q``'s minor
numbers; the device nodes this process holds (``/proc/self/fd``) before
CUDA starts, after ``torch.cuda.is_available()`` and after the device's
properties; those of a child holding a CUDA context, read from
``/proc/<pid>/fd`` (what the coordinator's holder scan reads); the CUDA
caching allocator capped by ``PYTORCH_CUDA_ALLOC_CONF=
per_process_memory_fraction:0.05`` against
``torch.cuda.set_per_process_memory_fraction(0.05)`` (a 2% allocation,
then a 10% one); a process group running bf16 matrix products on the
card under SIGSTOP for a second, then SIGCONT (its state letters and its
longest gap between two products); and whether flock blocks across
processes.  Changes no setting of the machine."""
import os
import signal
import subprocess
import sys
import time

import torch


def nv_fds(pid):
    out = []
    d = f"/proc/{pid}/fd"
    try:
        for fd in os.listdir(d):
            try:
                t = os.readlink(os.path.join(d, fd))
            except OSError as e:
                t = f"ERR {e}"
            if "nvidia" in t or "dev" in t:
                out.append(t)
    except OSError as e:
        out.append(f"listdir ERR {e}")
    return sorted(set(out))


smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print("card", smi, "torch", torch.__version__, torch.version.cuda, flush=True)
print("ls /dev", sorted(x for x in os.listdir("/dev") if "nvidia" in x),
      flush=True)
q = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True).stdout
print("minors", [l.strip() for l in q.splitlines() if "Minor" in l], flush=True)
print("self fds at start", nv_fds(os.getpid()), flush=True)
torch.cuda.is_available()
print("self fds after is_available", nv_fds(os.getpid()), flush=True)
torch.cuda.get_device_properties(0)
torch.cuda.get_device_name(0)
print("self fds after properties", nv_fds(os.getpid()), flush=True)

# child holding a context
child = subprocess.Popen([sys.executable, "-c",
    "import torch, time, sys; x = torch.zeros(1, device='cuda'); "
    "torch.cuda.synchronize(); print('open', flush=True); time.sleep(30)"],
    stdout=subprocess.PIPE, text=True)
print("child line", child.stdout.readline().strip(), flush=True)
print("child fds", nv_fds(child.pid), flush=True)
try:
    print("child comm", open(f"/proc/{child.pid}/comm").read().strip(),
          "stat", open(f"/proc/{child.pid}/stat").read()[:200], flush=True)
except OSError as e:
    print("child proc read err", e)
print("pgid child", os.getpgid(child.pid), "self", os.getpgid(0), flush=True)
print("listdir /proc digits", len([e for e in os.listdir("/proc")
                                   if e.isdigit()]), flush=True)
child.kill()
child.wait()

# alloc conf probe
code = r"""
import os, sys, json, torch
frac_api = float(sys.argv[1])
if frac_api > 0:
    torch.cuda.set_per_process_memory_fraction(frac_api, 0)
total = torch.cuda.get_device_properties(0).total_memory
res = {"conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"), "api": frac_api,
       "total": total}
try:
    a = torch.empty(int(0.02 * total), dtype=torch.uint8, device="cuda")
    res["small_ok"] = True
    res["reserved"] = torch.cuda.memory_reserved()
except Exception as e:
    res["small_ok"] = repr(e)[:200]
try:
    b = torch.empty(int(0.10 * total), dtype=torch.uint8, device="cuda")
    res["big"] = "allocated"
except torch.cuda.OutOfMemoryError as e:
    res["big"] = "OOM " + str(e)[:300]
except Exception as e:
    res["big"] = "other " + repr(e)[:300]
print(json.dumps(res))
"""
for conf, api in (("per_process_memory_fraction:0.05", 0.0),
                  ("", 0.05),
                  ("expandable_segments:True,per_process_memory_fraction:0.05", 0.0)):
    env = dict(os.environ)
    if conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = conf
    r = subprocess.run([sys.executable, "-c", code, str(api)], env=env,
                       capture_output=True, text=True, timeout=120)
    print("allocconf", conf or "-", api, "rc", r.returncode,
          r.stdout.strip()[-800:], r.stderr.strip()[-1500:], flush=True)

# SIGSTOP probe: a group running CUDA work with host stamps
code = r"""
import sys, time, torch
x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
torch.cuda.synchronize()
print("go", flush=True)
end = time.time() + float(sys.argv[1])
stamps = []
while time.time() < end:
    y = x @ x
    torch.cuda.synchronize()
    stamps.append(time.time())
gaps = sorted((b - a for a, b in zip(stamps, stamps[1:])), reverse=True)[:3]
print("done", len(stamps), [round(g, 3) for g in gaps], float(y.float().abs().max()), flush=True)
"""
p = subprocess.Popen([sys.executable, "-c", code, "4"], stdout=subprocess.PIPE,
                     text=True, start_new_session=True)
print("stop child", p.stdout.readline().strip(), flush=True)
time.sleep(1.0)
t0 = time.time()
os.killpg(p.pid, signal.SIGSTOP)
time.sleep(0.2)
state = open(f"/proc/{p.pid}/stat").read().rsplit(")", 1)[1].split()[0]
print("state after SIGSTOP", state, flush=True)
time.sleep(1.0)
os.killpg(p.pid, signal.SIGCONT)
time.sleep(0.1)
state = open(f"/proc/{p.pid}/stat").read().rsplit(")", 1)[1].split()[0]
print("state after SIGCONT", state, "stopped for", round(time.time() - t0, 3),
      flush=True)
print("stop child tail", p.stdout.read().strip(), "rc", p.wait(), flush=True)

# flock across processes
import fcntl
import shutil
import tempfile
lock_dir = tempfile.mkdtemp()
path = os.path.join(lock_dir, "probe.lock")
f = open(path, "w")
fcntl.flock(f, fcntl.LOCK_EX)
q = subprocess.Popen([sys.executable, "-c",
    "import fcntl, sys, time; f = open(sys.argv[1], 'w'); t = time.time(); "
    "fcntl.flock(f, fcntl.LOCK_EX); print(round(time.time() - t, 3))", path],
    stdout=subprocess.PIPE, text=True)
time.sleep(0.5)
fcntl.flock(f, fcntl.LOCK_UN)
print("flock waited", q.communicate(timeout=20)[0].strip(), flush=True)
f.close()
shutil.rmtree(lock_dir)
print("self fds at end", nv_fds(os.getpid()), flush=True)
