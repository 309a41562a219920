"""Rules-driven parameter layouts: per-model partition-rule tables.

The port's copy of ``k8s_dra_driver_tpu/models/layouts.py``, the tables
entry for entry, written in the port's ``PartitionSpec``
(parallel/mesh.py).  ``models/transformer.py`` cuts each rank's
blocks by them (``param_specs``, ``shard_params``) on any dp x ep x sp
x tp x pp process mesh, and the sharded checkpoint
(parallel/resharding.py) writes each leaf in the blocks its rule gives
on the formation it is handed.

Layout here is declarative data — an ordered table of
``(regex, PartitionSpec)`` matched against '/'-joined pytree leaf
names by ``parallel/resharding.py: match_partition_rules`` — the same
move the reference driver makes when MIG placement is selected by CEL
expression over declared profiles instead of enumerated in code
(deviceclass.go:31-47).  One table lays a model out on ANY
dp×ep×sp×tp×pp mesh: axes a mesh lacks are size-1, so the same spec
degrades gracefully.

First match wins, so order encodes precedence; an unmatched leaf is a
hard error (a new parameter must be placed deliberately).
"""

from __future__ import annotations

from ..parallel.mesh import P

Rule = tuple[str, P]


def _layer_rules(cfg) -> list[Rule]:
    rules: list[Rule] = [
        # norm gains replicate; attention projections split heads on
        # tp (wq/wk/wv head axis is dim 1, wo's is dim 0)
        (r"ln[12]$", P(None)),
        (r"w[qkv]$", P(None, "tp", None)),
        (r"wo$", P("tp", None, None)),
    ]
    if cfg.is_moe:
        rules += [
            # router replicates (every token scores every expert);
            # expert weights split experts on ep and d_ff on tp
            (r"router$", P(None, None)),
            (r"w_in$", P("ep", None, "tp")),
            (r"w_out$", P("ep", "tp", None)),
        ]
    else:
        rules += [
            (r"w_in$", P(None, "tp")),
            (r"w_out$", P("tp", None)),
        ]
    return rules


def transformer_rules(cfg) -> tuple[Rule, ...]:
    """The transformer's full layout table for ``cfg``.

    Matches every leaf of ``init_params``' tree (and the staged tree
    ``stage_params`` produces when ``cfg.pp_stages > 1``: those
    leaves are ``stages/<name>`` with shape [S, L/S, ...], stage axis
    on pp and the per-layer spec shifted right two dims).  Pinned
    against the JAX package's table by
    tests/test_torch_watchdog_resharding.py.
    """
    rules: list[Rule] = [
        (r"^embed$", P(None, "tp")),
        (r"^unembed$", P("tp", None)),
        (r"^ln_f$", P(None)),
    ]
    layer = _layer_rules(cfg)
    if cfg.pp_stages > 1:
        layer = [(rf"^stages/{pat}", P("pp", None, *tuple(spec)))
                 for pat, spec in layer]
    return tuple(rules + layer)


#: attention leaves a LoRA adapter may target (serving_lora/).  K/V
#: projections are excluded BY DESIGN: prompt K/V rows and every
#: prefix-cache/CoW-shared block stay adapter-independent, so paged
#: prefix sharing keeps working across adapters.
LORA_TARGETS = ("wq", "wo")


def lora_rules(cfg) -> tuple[Rule, ...]:
    """Layout table for one adapter's low-rank leaves
    (``layers/<i>/<target>/<A|B>``): the A/B factor whose axis
    touches a head dimension inherits the base leaf's tp split
    (wq splits heads on B's dim 1, wo on A's dim 0 — the same axes
    ``transformer_rules`` splits for the base weights), the
    rank-``r`` axis always replicates.  First match wins, unmatched
    adapter leaves are a hard error, exactly as for the base table.
    """
    return (
        (r"wq/A$", P(None, None)),          # [d, r]
        (r"wq/B$", P(None, "tp", None)),    # [r, H, K] heads on tp
        (r"wo/A$", P("tp", None, None)),    # [H, K, r] heads on tp
        (r"wo/B$", P(None, None)),          # [r, d]
    )


__all__ = ["Rule", "transformer_rules", "lora_rules", "LORA_TARGETS"]
