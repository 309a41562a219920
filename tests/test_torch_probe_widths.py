"""The port's probes run the JAX package's own model configurations.

Each probe's default ``TransformerConfig`` is captured from both
packages as the probe builds it (the first config constructed, caught in
``__post_init__`` before any weight is made) and compared field by
field, dtypes by name.  The card's kernels take the head dims these
configs have (8, 16 and 32), so no default differs from the reference.
Then the probe commands: each JAX ``main``'s flags are the port's, and
the port's ``main`` passes them on with ``--device``.
"""

import ast
import dataclasses
import importlib
import json
from pathlib import Path

import pytest
import torch

from k8s_dra_driver_tpu.models import transformer as jtr
from k8s_dra_driver_tpu_torch.models import transformer as ttr

ROOT = Path(__file__).resolve().parents[1]


class Captured(BaseException):
    """Raised from ``__post_init__`` with the config being built (a
    BaseException, so no ``except Exception`` in a probe swallows it)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg


def first_config(monkeypatch, cls, run):
    """The first ``cls`` config ``run()`` constructs, or the config
    it returns (the crucible's model getters, which cache theirs)."""
    post = cls.__post_init__

    def capture(self):
        post(self)
        raise Captured(self)

    monkeypatch.setattr(cls, "__post_init__", capture)
    try:
        out = run()
    except Captured as c:
        return c.cfg
    finally:
        monkeypatch.setattr(cls, "__post_init__", post)
    out = out[0] if isinstance(out, tuple) else out
    assert isinstance(out, cls), "the probe built no config"
    return out


def jax_mod(name):
    return importlib.import_module(f"k8s_dra_driver_tpu.{name}")


def port_mod(name):
    return importlib.import_module(f"k8s_dra_driver_tpu_torch.{name}")


SMALL_OBS = dict(n_requests=4, reps=1, pumps=1, replicas=1, slots=1,
                 queue_capacity=4)

# probe -> (module, JAX call, port call): each call runs the probe at
# its defaults (the observatory probe at tiny request counts, which do
# not shape its model) until it builds its model
PROBES = {
    "spec_decode_probe": (
        "models.specprobe", lambda m: m.spec_decode_probe(),
        lambda m: m.spec_decode_probe(device="cpu")),
    "paged_kv_probe": (
        "serving_kv.probe", lambda m: m.paged_kv_probe(),
        lambda m: m.paged_kv_probe(device="cpu")),
    "serving_tier_probe": (
        "serving_kv.tierprobe", lambda m: m.serving_tier_probe(),
        lambda m: m.serving_tier_probe(device="cpu")),
    "lora_serving_probe": (
        "serving_lora.probe", lambda m: m.lora_serving_probe(),
        lambda m: m.lora_serving_probe(device="cpu")),
    "observatory_probe": (
        "gateway.obsprobe", lambda m: m.observatory_probe(**SMALL_OBS),
        lambda m: m.observatory_probe(**SMALL_OBS, device="cpu")),
    "recovery_probe": (
        "parallel.probe", lambda m: m.recovery_probe(),
        lambda m: m.recovery_probe(device="cpu")),
    "fleet_probe": (
        "fleet.probe", lambda m: m.fleet_probe(),
        lambda m: m.fleet_probe(device="cpu")),
    "multitenant_probe": (
        "fleet.probe", lambda m: m.multitenant_probe(),
        lambda m: m.multitenant_probe(device="cpu")),
    "crucible model": (
        "cluster.crucible", lambda m: m._cfg(),
        lambda m: m.default_model("cpu")),
}


def dtype_name(v) -> str:
    import numpy as np
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    return np.dtype(v).name


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_default_config_is_the_jax_probes(monkeypatch, probe):
    mod, jrun, trun = PROBES[probe]
    jax_cfg = first_config(monkeypatch, jtr.TransformerConfig,
                           lambda: jrun(jax_mod(mod)))
    port_cfg = first_config(monkeypatch, ttr.TransformerConfig,
                            lambda: trun(port_mod(mod)))
    names = [f.name for f in dataclasses.fields(port_cfg)]
    assert names == [f.name for f in dataclasses.fields(jax_cfg)]
    for name in names:
        j, t = getattr(jax_cfg, name), getattr(port_cfg, name)
        if name == "dtype":
            j, t = dtype_name(j), dtype_name(t)
        assert t == j, (probe, name)
    # and the head dim is one the card's kernels take
    from k8s_dra_driver_tpu_torch.ops import flash_attention as tfa
    assert port_cfg.d_head in tfa._KERNEL_HEAD_DIMS


@pytest.mark.parametrize("mod,probe_dims", [
    ("models.specprobe", 16), ("serving_lora.probe", 16),
    ("serving_kv.probe", 16), ("serving_kv.tierprobe", 32)])
def test_probe_config_functions_give_the_defaults(mod, probe_dims):
    """The port's ``probe_config`` is what its probe builds by default."""
    cfg = port_mod(mod).probe_config()
    assert cfg.d_head == probe_dims and cfg.dtype == torch.float32


def test_dispatch_probe_defaults_are_the_jax_probes():
    import inspect
    jsig = inspect.signature(jax_mod("ops.collectives").dispatch_probe)
    tsig = inspect.signature(port_mod("ops.collectives").dispatch_probe)
    for name, p in jsig.parameters.items():
        assert tsig.parameters[name].default == p.default, name
    assert set(tsig.parameters) - set(jsig.parameters) == {"device"}


# -- the probe commands ---------------------------------------------------

MAINS = {
    "models.specprobe": "spec_decode_probe",
    "serving_kv.probe": "paged_kv_probe",
    "serving_kv.tierprobe": "serving_tier_probe",
    "serving_lora.probe": "lora_serving_probe",
}


def main_flags(path: Path) -> dict:
    """``--flag``: default of every ``add_argument`` in ``main``."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = ast.literal_eval(kw["default"])
    return out


@pytest.mark.parametrize("mod", sorted(MAINS))
def test_probe_main_takes_the_jax_flags_and_a_device(mod):
    rel = mod.replace(".", "/") + ".py"
    jflags = main_flags(ROOT / "k8s_dra_driver_tpu" / rel)
    tflags = main_flags(ROOT / "k8s_dra_driver_tpu_torch" / rel)
    assert tflags == {**jflags, "--device": "cuda"}


@pytest.mark.parametrize("mod", sorted(MAINS))
def test_probe_main_passes_its_flags_on(mod, monkeypatch, capsys):
    m = port_mod(mod)
    calls = []

    def probe(**kw):
        calls.append(kw)
        return {"ok": True}

    monkeypatch.setattr(m, MAINS[mod], probe)
    assert m.main(["--repeats", "2", "--device", "cpu"]) == 0
    assert calls[0]["repeats"] == 2 and calls[0]["device"] == "cpu"
    assert json.loads(capsys.readouterr().out) == {"ok": True}
    assert m.main([]) == 0
    assert calls[1]["device"] == "cuda"
