"""Vendored CDI v0.x spec-file schema + write-time validation.

The port's copy of ``k8s_dra_driver_tpu/plugin/cdi_schema.py``.  The
container-runtime boundary is not crossed in the tests (no
containerd), so the strongest available proof
that the specs the plugin writes are ones a real CDI-enabled runtime
would accept is schema-level: this module pins the CDI spec-file
structure as a JSON Schema — transcribed from the published CNCF
Container Device Interface specification (SPEC.md, v0.6.0 line) — and
``CDIHandler`` validates every spec at write time against it, so a
generation bug fails the prepare loudly instead of surfacing as a
container-create error on a cluster we cannot run.

The reference delegates this guarantee to the vendored
``container-device-interface`` Go library its CDIHandler builds specs
through (reference cmd/nvidia-dra-plugin/cdi.go:50-298 uses
``specs-go`` types + ``pkg/cdi`` writers that validate internally);
re-implementing the validation contract rather than trusting output
shape is the same discipline.

Scope: v0.6.0 fields the generator can emit plus the rest of the 0.x
structure (hooks, device-node attributes) so the schema stays valid
as the generator grows.  Identifier rules follow the spec: vendor and
class from the qualified-name grammar, device names alphanumeric plus
``-``, ``_``, ``.``, ``:``.
"""

from __future__ import annotations

CDI_SPEC_SCHEMA: dict = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "type": "object",
    "required": ["cdiVersion", "kind", "devices"],
    "additionalProperties": False,
    "properties": {
        "cdiVersion": {
            "type": "string",
            # the 0.x line this generator targets; 0.7+ adds fields
            # (intelRdt, additionalGIDs) the schema below doesn't vet
            "enum": ["0.3.0", "0.4.0", "0.5.0", "0.6.0"],
        },
        "kind": {
            "type": "string",
            # vendor/class per the qualified-name grammar
            "pattern": r"^[A-Za-z0-9][A-Za-z0-9.\-_]*"
                       r"/[A-Za-z0-9][A-Za-z0-9.\-_]*$",
        },
        "annotations": {
            "type": "object",
            "additionalProperties": {"type": "string"},
        },
        "devices": {
            # no minItems: a chipless node writes an empty standard
            # spec at startup and idles (pre-validation behavior kept
            # — the plugin must not crash where it used to publish
            # zero allocatable devices)
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "containerEdits"],
                "additionalProperties": False,
                "properties": {
                    "name": {
                        "type": "string",
                        "pattern": r"^[A-Za-z0-9][A-Za-z0-9_.:\-]*$",
                    },
                    "annotations": {
                        "type": "object",
                        "additionalProperties": {"type": "string"},
                    },
                    "containerEdits": {
                        "$ref": "#/definitions/containerEdits"},
                },
            },
        },
        "containerEdits": {"$ref": "#/definitions/containerEdits"},
    },
    "definitions": {
        "containerEdits": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "env": {
                    "type": "array",
                    "items": {"type": "string",
                              "pattern": r"^[^=]+=.*$"},
                },
                "deviceNodes": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["path"],
                        "additionalProperties": False,
                        "properties": {
                            "path": {"type": "string",
                                     "pattern": r"^/"},
                            "hostPath": {"type": "string",
                                         "pattern": r"^/"},
                            "type": {"type": "string",
                                     "enum": ["b", "c", "u", "p"]},
                            "major": {"type": "integer"},
                            "minor": {"type": "integer"},
                            "fileMode": {"type": "integer"},
                            "permissions": {"type": "string"},
                            "uid": {"type": "integer"},
                            "gid": {"type": "integer"},
                        },
                    },
                },
                "mounts": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["hostPath", "containerPath"],
                        "additionalProperties": False,
                        "properties": {
                            "hostPath": {"type": "string",
                                         "pattern": r"^/"},
                            "containerPath": {"type": "string",
                                              "pattern": r"^/"},
                            "options": {
                                "type": "array",
                                "items": {"type": "string"},
                            },
                            "type": {"type": "string"},
                        },
                    },
                },
                "hooks": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["hookName", "path"],
                        "additionalProperties": False,
                        "properties": {
                            "hookName": {
                                "type": "string",
                                "enum": ["prestart",
                                         "createRuntime",
                                         "createContainer",
                                         "startContainer",
                                         "poststart", "poststop"],
                            },
                            "path": {"type": "string",
                                     "pattern": r"^/"},
                            "args": {"type": "array",
                                     "items": {"type": "string"}},
                            "env": {"type": "array",
                                    "items": {
                                        "type": "string",
                                        "pattern": r"^[^=]+=.*$"}},
                            "timeout": {"type": "integer"},
                        },
                    },
                },
            },
        },
    },
}


class CDISchemaError(ValueError):
    """A generated spec violates the vendored CDI schema."""


def validate_spec(spec: dict) -> None:
    """Raise :class:`CDISchemaError` if ``spec`` is not a valid CDI
    v0.x spec file.  Runs on every spec the plugin writes
    (``CDIHandler._write``) — cheap (specs are a few KB) and the only
    runtime-boundary proof available without a container runtime."""
    import jsonschema

    try:
        jsonschema.validate(spec, CDI_SPEC_SCHEMA)
    except jsonschema.ValidationError as e:
        path = "/".join(str(p) for p in e.absolute_path) or "<root>"
        raise CDISchemaError(
            f"generated CDI spec violates the v0.x schema at "
            f"{path}: {e.message}") from e
