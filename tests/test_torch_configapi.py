"""The port's config API against the JAX package's
(tests/test_configapi.py's cases): both packages' quantity parser, strict
decoder, normalization, validation and HBM-limit resolution on the same
inputs, their results equal field by field and their errors of the same
type with the same message."""

import pytest

from torch_driver import JAX, PORT, as_dict

UUIDS = ["TPU-v5e-aaaa", "TPU-v5e-bbbb", "TPU-v5e-cccc"]
GiB = 1024 ** 3
API = PORT.configapi.API_VERSION


def run_both(fn):
    """``fn(pkg)`` through each package: ("ok", value) or (error type
    name, message); the two must be equal.  Returns the port's."""
    out = []
    for pkg in (JAX, PORT):
        try:
            value = fn(pkg)
            out.append(("ok", as_dict(value) if hasattr(
                value, "__dataclass_fields__") else value))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
    return out[1]


def decoded(params, validate=True):
    def fn(pkg):
        cfg = pkg.configapi.decode(params)
        cfg.normalize()
        if validate:
            cfg.validate()
        return cfg
    return run_both(fn)


class TestQuantity:
    @pytest.mark.parametrize("s,want", [
        ("16Gi", 16 * GiB), ("500M", 500 * 10**6), ("1024", 1024),
        ("2Ti", 2 * 1024**4), ("1.5Gi", int(1.5 * GiB)), (42, 42),
    ])
    def test_parse(self, s, want):
        assert run_both(lambda pkg: pkg.quantity.parse_quantity(s)) == (
            "ok", want)

    @pytest.mark.parametrize("bad", ["", "abc", "12Q", "-5Gi"])
    def test_parse_rejects(self, bad):
        kind, _ = run_both(lambda pkg: pkg.quantity.parse_quantity(bad))
        assert kind == "QuantityError"

    @pytest.mark.parametrize("n", [16 * GiB, 1000, 3 * 1024 ** 2, 0])
    def test_format(self, n):
        got = run_both(lambda pkg: pkg.quantity.format_quantity(n))
        assert got[0] == "ok"


class TestDecoder:
    def test_chip_config_roundtrip(self):
        kind, cfg = decoded({"apiVersion": API, "kind": "TpuChipConfig",
                             "sharing": {"strategy": "TimeSlicing",
                                         "timeSlicing": {"interval": "Short"}}})
        assert kind == "ok"
        assert cfg["sharing"]["time_slicing"]["interval"] == "Short"

    @pytest.mark.parametrize("params,match", [
        ({"apiVersion": API, "kind": "TpuChipConfig", "sharingg": {}},
         "unknown field"),
        ({"apiVersion": API, "kind": "GpuConfig"}, "unsupported kind"),
        ({"apiVersion": "nvidia.com/v1", "kind": "TpuChipConfig"},
         "unsupported apiVersion"),
        ({"apiVersion": API, "kind": "TpuChipConfig",
          "sharing": {"strateggy": "Exclusive"}}, "unknown field"),
        ({"apiVersion": API, "kind": "TpuChipConfig", "sharing": 3},
         "expected object"),
        ("not a dict", "must be an object"),
        ({"apiVersion": API, "kind": "RendezvousConfig", "port": 0,
          "barrierTimeoutS": 1, "extra": 1}, "unknown field"),
    ])
    def test_rejects(self, params, match):
        kind, msg = run_both(lambda pkg: pkg.configapi.decode(params))
        assert kind == "ConfigError" and match in msg

    def test_rendezvous_defaults(self):
        kind, cfg = decoded({"apiVersion": API, "kind": "RendezvousConfig"})
        assert (cfg["port"], cfg["barrier_timeout_s"]) == (8471, 600)

    def test_decoded_types_have_the_jax_names(self):
        for kind in ("TpuChipConfig", "TpuPartitionConfig",
                     "RendezvousConfig"):
            cfg = PORT.configapi.decode({"apiVersion": API, "kind": kind})
            assert type(cfg).__name__ == kind == cfg.KIND


class TestSharingValidation:
    def test_default_is_exclusive(self):
        got = run_both(lambda pkg: pkg.configapi.TpuChipConfig.default())
        assert got[1]["sharing"]["strategy"] == "Exclusive"

    def test_unknown_strategy(self):
        def fn(pkg):
            cfg = pkg.configapi.TpuChipConfig()
            cfg.sharing.strategy = "MPS"
            cfg.validate()
        kind, msg = run_both(fn)
        assert "unknown sharing strategy" in msg

    @pytest.mark.parametrize("kind,sharing,match", [
        ("TpuChipConfig", {"strategy": "Exclusive",
                           "timeSlicing": {"interval": "Short"}},
         "strategy is Exclusive"),
        ("TpuChipConfig", {"strategy": "TimeSlicing",
                           "timeSlicing": {"interval": "Tiny"}},
         "unknown time-slice interval"),
        ("TpuPartitionConfig", {"strategy": "TimeSlicing"},
         "not supported on core"),
        ("TpuChipConfig", {"strategy": "Exclusive",
                           "coordinated": {"dutyCyclePercent": 50}},
         "coordinated settings given"),
    ])
    def test_rejected_sharing(self, kind, sharing, match):
        got = decoded({"apiVersion": API, "kind": kind, "sharing": sharing})
        assert got[0] == "ConfigError" and match in got[1]

    def test_partition_allows_coordinated(self):
        kind, cfg = decoded({"apiVersion": API, "kind": "TpuPartitionConfig",
                             "sharing": {"strategy": "Coordinated"}})
        assert cfg["sharing"]["coordinated"]["duty_cycle_percent"] == 100

    @pytest.mark.parametrize("bad", [-1, 101, 1000])
    def test_duty_cycle_bounds(self, bad):
        got = run_both(lambda pkg: pkg.configapi.CoordinatedSettings(
            duty_cycle_percent=bad).validate())
        assert got[0] == "ConfigError"

    def test_enforcement_fields_decode_and_validate(self):
        kind, cfg = decoded({"apiVersion": API, "kind": "TpuChipConfig",
                             "sharing": {"strategy": "Coordinated",
                                         "coordinated": {
                                             "dutyCyclePercent": 50,
                                             "enforce": True,
                                             "violationAction": "terminate"}}})
        assert cfg["sharing"]["coordinated"]["enforce"] is True
        for kw, match in (({"violation_action": "reboot"}, "violationAction"),
                          ({"enforce": "false"}, "boolean")):
            got = run_both(lambda pkg: pkg.configapi.CoordinatedSettings(
                **kw).validate())
            assert got[0] == "ConfigError" and match in got[1]

    @pytest.mark.parametrize("port,timeout", [(70000, 600), (8471, -1)])
    def test_rendezvous_validation(self, port, timeout):
        def fn(pkg):
            cfg = pkg.configapi.RendezvousConfig(port=port,
                                                 barrier_timeout_s=timeout)
            cfg.normalize()
            cfg.validate()
        assert run_both(fn)[0] == "ConfigError"


class TestHbmLimitResolution:
    def resolve(self, limits):
        def fn(pkg):
            s = pkg.configapi.CoordinatedSettings(
                per_device_hbm_limits=dict(limits))
            s.validate()
            return s.resolved_hbm_limits(UUIDS)
        return run_both(fn)

    @pytest.mark.parametrize("limits,want", [
        ({}, {}),
        ({"default": "8Gi"}, {u: 8 * GiB for u in UUIDS}),
        ({"default": "8Gi", UUIDS[1]: "4Gi"},
         {UUIDS[0]: 8 * GiB, UUIDS[1]: 4 * GiB, UUIDS[2]: 8 * GiB}),
        ({"0": "2Gi"}, {UUIDS[0]: 2 * GiB}),
        ({"default": "8Gi", "2": "1Gi"},
         {UUIDS[0]: 8 * GiB, UUIDS[1]: 8 * GiB, UUIDS[2]: GiB}),
        ({"default": "1000M"}, {u: 10 ** 9 for u in UUIDS}),
    ])
    def test_resolves(self, limits, want):
        assert self.resolve(limits) == ("ok", want)

    @pytest.mark.parametrize("limits,error", [
        ({"TPU-v5e-zzzz": "1Gi"}, "InvalidDeviceSelectorError"),
        ({"7": "1Gi"}, "InvalidDeviceSelectorError"),
        ({"default": "1Qx"}, "InvalidLimitError"),
    ])
    def test_rejects(self, limits, error):
        assert self.resolve(limits)[0] == error

    def test_h100_uuids_resolve(self):
        uuids = [c.uuid for c in PORT.discovery.H100_PROBE]
        s = PORT.configapi.CoordinatedSettings(
            per_device_hbm_limits={"default": "40Gi", uuids[1]: "20Gi"})
        s.validate()
        assert s.resolved_hbm_limits(uuids) == {uuids[0]: 40 * GiB,
                                                uuids[1]: 20 * GiB}
