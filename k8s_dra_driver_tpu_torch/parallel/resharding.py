"""Crash-safe elastic resharding: rules-driven layouts + sharded,
checksummed, streaming checkpoint I/O.

The port of ``k8s_dra_driver_tpu/parallel/resharding.py``, in the
reference's on-disk format, so a generation written by either package
restores in the other:

- ``match_partition_rules``: a regex-over-tree table maps leaf path
  names ("layers/3/wq") to ``PartitionSpec``s (parallel/mesh.py), so a
  model's layout is declarative data.  Per-model tables live in
  ``models/layouts.py``; first match wins, scalar leaves are
  replicated, an unmatched leaf is an error — a silent default would
  hand a new parameter a layout nobody chose.  A tree is dicts (keys
  in sorted order), lists and tuples over tensor or array leaves,
  flattened in the order ``jax.tree_util`` flattens the same nesting.

- ``ShardedCheckpointer``: a generation is a directory of raw per-
  shard files plus ONE ``manifest.json`` (shape / dtype / spec /
  crc32 / byte-bounds per shard) written LAST through
  ``utils/atomicio.py`` — manifest presence IS the commit point.
  Restore reads only the shard files that intersect each requested
  slice (``read_slice``), and every byte read is checked against the
  manifest first, so a flipped bit, a truncated file or a missing
  shard classifies the generation unreadable and the newest-first
  fallback resumes from the previous good generation.

A save is handed whole tensors.  Given the formation it was made on
(``mesh=``, a ``MeshSpec``) and a checkpointer built with a rule table
(``rules=``), it cuts each leaf into the blocks the reference writes
for that leaf's spec on that mesh: one file per distinct block, in the
order of the mesh positions (row-major, as JAX orders a mesh's
devices), replicas once — so a generation the port saves from dp=2 x
tp=4 has the manifest JAX writes from the same weights on the same
mesh.  Without a mesh (or a rule) a leaf is one shard.  Restore
assembles any layout from its shards.  Leaf names are the reference's
slash names under ``params/`` and ``opt_state/``.  A ``torch.optim.AdamW``
is written under optax's ``adamw`` state names (:func:`adamw_leaves`):
``opt_state/0/count`` (int32), ``opt_state/0/mu/<param path>``
(``exp_avg``) and ``opt_state/0/nu/<param path>`` (``exp_avg_sq``),
with zero moments and count 0 for parameters the optimizer has not
stepped yet (optax's ``init``).  bfloat16 leaves are stored as the
reference stores them (dtype ``"bfloat16"``, two bytes an element).
"""

from __future__ import annotations

import json
import logging
import re
import shutil
import zlib
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from ..cluster import faults
from ..utils import atomicio
from .mesh import P, PartitionSpec, mesh_coords, spec_block

log = logging.getLogger(__name__)

FORMAT = "tpu-dra-sharded-ckpt/1"
MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"


class ShardCorruption(RuntimeError):
    """A generation that must not be restored from: missing/garbled
    manifest, missing shard file, truncation, or checksum mismatch."""


# ---------------------------------------------------------------- trees

def _key_str(k) -> str:
    if hasattr(k, "key"):       # the reference's DictKey
        return str(k.key)
    if hasattr(k, "idx"):       # SequenceKey
        return str(k.idx)
    if hasattr(k, "name"):      # GetAttrKey
        return str(k.name)
    return str(k)


def leaf_name(path) -> str:
    """'/'-joined name of a leaf's key path."""
    return "/".join(_key_str(k) for k in path)


def _is_node(node) -> bool:
    """Dicts, lists and tuples are inner nodes; a ``PartitionSpec``
    (a tuple) is a leaf."""
    return (isinstance(node, (dict, list, tuple))
            and not isinstance(node, PartitionSpec))


def _children(node):
    """``[(key, child), ...]`` of an inner node, None for a leaf."""
    if not _is_node(node):
        return None
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def tree_flatten_with_path(tree, prefix: tuple = ()) -> list:
    """``[(key path, leaf), ...]`` in flatten order; ``None`` is an
    empty subtree, as in ``jax.tree_util``."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for k, child in kids
            for pair in tree_flatten_with_path(child, prefix + (k,))]


def tree_map(fn, tree, prefix: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, x, prefix + (i,))
                 for i, x in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(prefix, tree)


def tree_leaf_names(tree) -> list[str]:
    return [leaf_name(p) for p, _ in tree_flatten_with_path(tree)]


def match_partition_rules(rules: Sequence[tuple[str, Any]], tree):
    """Map every leaf of ``tree`` to a PartitionSpec via regex rules.

    ``rules`` is an ordered table of ``(pattern, PartitionSpec)``;
    the FIRST pattern that ``re.search``-matches the leaf's
    '/'-joined path name wins.  Leaves with zero or one element are
    replicated (``P()``) without consulting the table — a scalar has
    nothing to shard.  A leaf no rule matches raises ``ValueError``
    naming it: a silent replicate-by-default would let a new
    parameter ship with a layout nobody reviewed.
    """
    def spec(path, leaf):
        name = leaf_name(path)
        shape = getattr(leaf, "shape", None)
        if shape is not None and (
                len(shape) == 0 or int(np.prod(tuple(shape))) == 1):
            return P()
        for pattern, s in rules:
            if re.search(pattern, name):
                return s
        raise ValueError(
            f"no partition rule matches leaf {name!r} "
            f"(shape {tuple(shape) if shape else None}); add a "
            f"rule to the model's table in models/layouts.py")
    return tree_map(spec, tree)


def encode_spec(spec) -> list:
    """PartitionSpec -> JSON-able list (axis name, axis tuple, None)."""
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in tuple(spec)]


def decode_spec(entries: Sequence) -> PartitionSpec:
    return P(*[tuple(e) if isinstance(e, list) else e
               for e in entries])


# ------------------------------------------------- the optimizer's names

def _bound_names(params, opt: torch.optim.Optimizer) -> list:
    """``[(param path, tensor), ...]`` of ``params``' leaves, checked to
    be exactly the tensors ``opt`` is bound to."""
    leaves = tree_flatten_with_path(params)
    bound = [p for g in opt.param_groups for p in g["params"]]
    if (len(bound) != len(leaves)
            or {id(p) for p in bound} != {id(t) for _, t in leaves}):
        raise ValueError("the optimizer is not bound to these params "
                         "(build both with init_state)")
    return [(leaf_name(path), t) for path, t in leaves]


def adamw_leaves(params, opt: torch.optim.Optimizer) -> dict:
    """A ``torch.optim.AdamW`` bound to ``params``' leaves as optax's
    ``adamw`` state: ``{"0/count": int32 scalar, "0/mu/<param path>":
    exp_avg, "0/nu/<param path>": exp_avg_sq}`` (the names below
    ``opt_state/``).  A parameter without optimizer state yet (AdamW
    creates it at the first step) gets zero moments in its own dtype,
    what optax's ``init`` holds; ``count`` is the optimizer's step."""
    if not isinstance(opt, torch.optim.AdamW):
        raise TypeError(f"optax's adamw names hold a torch.optim.AdamW "
                        f"state, not a {type(opt).__name__}'s")
    out, steps = {}, []
    named = _bound_names(params, opt)
    for name, p in named:
        st = opt.state.get(p) or {}
        if "exp_avg" in st:
            out[f"0/mu/{name}"] = st["exp_avg"]
            out[f"0/nu/{name}"] = st["exp_avg_sq"]
            steps.append(int(float(st["step"])))
        else:
            out[f"0/mu/{name}"] = torch.zeros_like(p.detach())
            out[f"0/nu/{name}"] = torch.zeros_like(p.detach())
    if len(set(steps)) > 1:
        raise ValueError(f"AdamW steps differ across parameters: "
                         f"{sorted(set(steps))}")
    out["0/count"] = torch.tensor(steps[0] if steps else 0,
                                  dtype=torch.int32)
    return out


def load_adamw_leaves(params, opt: torch.optim.Optimizer,
                      leaves: dict) -> None:
    """Inverse of :func:`adamw_leaves`: set every parameter's AdamW
    state from optax's names — the moments cast to the parameter's
    device and dtype, torch's per-parameter float ``step`` from the
    one int32 ``count``.  Count 0 with zero moments leaves an optimizer
    whose next step equals a fresh one's."""
    count = float(int(torch.as_tensor(leaves["0/count"])))
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    for name, p in _bound_names(params, opt):
        g = group_of[id(p)]
        on_device = g.get("capturable") or g.get("fused")
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": _as_torch(leaves[f"0/mu/{name}"]).to(
                device=p.device, dtype=p.dtype),
            "exp_avg_sq": _as_torch(leaves[f"0/nu/{name}"]).to(
                device=p.device, dtype=p.dtype),
        }


# ------------------------------------------------------- sharded format

#: dtypes numpy lacks, stored as raw integers of their width
_RAW = {"bfloat16": (np.dtype(np.int16), torch.bfloat16)}


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as (bfloat16: int16)."""
    if name in _RAW:
        return _RAW[name][0]
    return np.dtype(name)


def _as_torch(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _host_block(leaf) -> tuple[np.ndarray, str]:
    """(host array of the leaf's bytes, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _raw_view(block: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(block).reshape(-1)
                      .view(np.uint8))


def _mangle(name: str) -> str:
    return name.replace("/", "__")


def _whole(shape) -> list[list[int]]:
    return [[0, int(d)] for d in shape]


class ShardedCheckpointer:
    """Save/restore (params, opt_state, step) as checksummed shards.

    API-compatible with models/checkpoint.py ``TrainCheckpointer``
    (save / latest_step / restore / restore_extra / close) so the
    supervisor swaps formats without code changes; the differences are
    the per-shard manifest, verify-on-restore, and slice-granular reads
    (``read_slice``).

    ``params`` is a tree of tensors (or numpy arrays); ``opt_state`` a
    ``torch.optim.AdamW`` bound to its leaves, written under optax's
    names, or any other tree.  ``rules`` (a ``models/layouts.py``
    table) records each parameter's spec in the manifest — the moments
    take their parameter's, ``count`` is replicated — where the
    reference records its arrays' shardings; without rules the specs
    are ``null``, as the reference writes them for unsharded arrays.

    ``verify=False`` skips only the crc32 pass (byte-length checks
    stay — a short file can never be reinterpreted as a full shard).
    """

    def __init__(self, directory: str | Path, keep: int = 3,
                 verify: bool = True, rules=None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.verify = verify
        self.rules = rules
        self.last_restore_stats: dict = {}
        # parsed-manifest cache keyed by (mtime_ns, size): a rewritten
        # or tampered-with manifest is never served stale
        self._manifest_cache: dict = {}

    # -- layout ---------------------------------------------------

    def step_path(self, step: int) -> Path:
        return self.directory / f"{_STEP_PREFIX}{step:08d}"

    def all_steps(self) -> list[int]:
        """Committed generations only (manifest present) — a step dir
        a crash left without its manifest is invisible."""
        out = []
        for d in self.directory.iterdir():
            if d.is_dir() and d.name.startswith(_STEP_PREFIX) \
                    and (d / MANIFEST).exists():
                try:
                    out.append(int(d.name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- the leaves of a (params, opt_state) pair -------------------

    def _save_leaves(self, params, opt_state) -> list:
        """``[(name, leaf, spec or None), ...]`` to write."""
        rules = self.rules
        named = [(f"params/{leaf_name(p)}", x)
                 for p, x in tree_flatten_with_path(params)]
        specs: dict = {}
        if rules is not None:
            flat = tree_flatten_with_path(
                match_partition_rules(rules, params))
            specs = {leaf_name(p): encode_spec(s) for p, s in flat}
        if isinstance(opt_state, torch.optim.Optimizer):
            opt = adamw_leaves(params, opt_state)
            named += [(f"opt_state/{k}", v) for k, v in opt.items()]
            if rules is not None:
                specs.update({f"0/mu/{k}": s for k, s in specs.items()}
                             | {f"0/nu/{k}": s for k, s in specs.items()}
                             | {"0/count": []})
        else:
            named += [(f"opt_state/{leaf_name(p)}", x)
                      for p, x in tree_flatten_with_path(opt_state)]
        return [(name, leaf, specs.get(name.split("/", 1)[1]))
                for name, leaf in named]

    # -- save -----------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any,
             wait: bool = True, extra: dict | None = None,
             mesh=None) -> None:
        """Write every leaf's shards, then commit by writing the
        manifest atomically.  ``mesh`` (a ``MeshSpec``: the formation
        that holds the tensors) cuts each leaf into the blocks of its
        spec under the checkpointer's ``rules`` on that mesh (module
        docstring).  A step that already
        has a committed generation is skipped, matching orbax's
        already-saved semantics — a replayed step after a restore
        recomputes the saved state, and rewriting it would only widen
        the torn-write window.  The write is synchronous; ``wait`` is
        accepted for API parity."""
        step = int(step)
        if step in set(self.all_steps()):
            return
        sd = self.step_path(step)
        if sd.exists():            # uncommitted debris from a crash
            shutil.rmtree(sd)
        sd.mkdir(parents=True)
        leaves = {}
        for name, leaf, spec in self._save_leaves(params, opt_state):
            leaves[name] = self._write_leaf(sd, name, leaf, spec, mesh)
        faults.crashpoint(faults.CRASH_RESHARD_SHARDS_WRITTEN)
        manifest = {"format": FORMAT, "step": step,
                    "extra": extra or {}, "leaves": leaves}
        atomicio.write_atomic(
            sd / MANIFEST,
            json.dumps(manifest, sort_keys=True, separators=(",", ":")))
        atomicio.fsync_dir(self.directory)
        faults.crashpoint(faults.CRASH_RESHARD_COMMITTED)
        self._prune()

    def _write_leaf(self, sd: Path, name: str, leaf, spec,
                    mesh=None) -> dict:
        whole, dtype = _host_block(leaf)
        shape = [int(d) for d in whole.shape]
        cuts = [_whole(shape)]
        if mesh is not None and spec:
            sizes = mesh.axis_sizes()
            cuts = []
            for rank in range(mesh.num_devices):
                bounds = spec_block(shape, spec, sizes,
                                    mesh_coords(rank, mesh))
                if bounds not in cuts:     # a replica of a written block
                    cuts.append(bounds)
        shards = []
        for i, bounds in enumerate(cuts):
            raw = _raw_view(whole[tuple(slice(lo, hi) for lo, hi in bounds)])
            fname = f"{_mangle(name)}.{i:03d}.bin"
            atomicio.write_durable_bytes(sd / fname, raw)
            shards.append({"file": fname, "bounds": bounds,
                           "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                           "nbytes": raw.nbytes})
        return {"shape": shape, "dtype": dtype, "spec": spec,
                "shards": shards}

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_path(s), ignore_errors=True)
        # crash debris: uncommitted dirs older than the newest commit
        newest = steps[-1] if steps else None
        for d in self.directory.iterdir():
            if d.is_dir() and d.name.startswith(_STEP_PREFIX) \
                    and not (d / MANIFEST).exists():
                try:
                    s = int(d.name[len(_STEP_PREFIX):])
                except ValueError:
                    continue
                if newest is not None and s < newest:
                    shutil.rmtree(d, ignore_errors=True)

    # -- restore --------------------------------------------------

    def restore(self, params_like: Any, opt_state_like: Any,
                step: int | None = None) -> tuple[Any, Any, int]:
        """Restore into the targets: tensor leaves are filled in place
        on their own device and dtype (an optimizer's state is set
        through :func:`load_adamw_leaves`), numpy leaves come back as
        new arrays of the target's dtype.  Every leaf of the generation
        is read and verified before any target is written.
        ``step=None`` picks the latest READABLE generation: any
        verification failure (checksum, truncation, missing shard,
        torn manifest) falls through newest-first to the previous
        good one.  An explicit ``step=`` stays strict.  Returns
        (params, opt_state, step)."""
        explicit = step is not None
        candidates = ([int(step)] if explicit
                      else sorted(self.all_steps(), reverse=True))
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint under {self.directory}")
        torn: list[str] = []
        for s in candidates:
            try:
                blocks = self._read_all(s, params_like, opt_state_like)
            except Exception as e:
                if explicit:
                    raise
                torn.append(f"step {s}: {type(e).__name__}: {e}")
                continue
            if torn:
                log.warning(
                    "sharded generation(s) unreadable, fell back to "
                    "step %d: %s", s,
                    "; ".join(t[:200] for t in torn))
            params = self._fill(params_like, "params/", blocks)
            if isinstance(opt_state_like, torch.optim.Optimizer):
                load_adamw_leaves(params_like, opt_state_like, {
                    k[len("opt_state/"):]: v for k, v in blocks.items()
                    if k.startswith("opt_state/")})
                opt = opt_state_like
            else:
                opt = self._fill(opt_state_like, "opt_state/", blocks)
            return params, opt, s
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.directory}: "
            f"{'; '.join(torn)}")

    def _targets(self, params_like, opt_state_like) -> list:
        """``[(name, target-like), ...]`` the generation must hold."""
        out = [(f"params/{leaf_name(p)}", x)
               for p, x in tree_flatten_with_path(params_like)]
        if isinstance(opt_state_like, torch.optim.Optimizer):
            named = _bound_names(params_like, opt_state_like)
            out += [(f"opt_state/0/{m}/{n}", t) for m in ("mu", "nu")
                    for n, t in named]
            out.append(("opt_state/0/count",
                        torch.zeros((), dtype=torch.int32)))
        else:
            out += [(f"opt_state/{leaf_name(p)}", x)
                    for p, x in tree_flatten_with_path(opt_state_like)]
        return out

    def _read_all(self, step: int, params_like, opt_state_like) -> dict:
        """Every target leaf of generation ``step``, read and verified
        into host tensors/arrays (nothing written into the targets)."""
        sd = self.step_path(step)
        leaves = self._read_manifest(sd)["leaves"]
        stats = {"files_read": 0, "bytes_read": 0}
        out = {}
        for name, like in self._targets(params_like, opt_state_like):
            ent = leaves.get(name)
            if ent is None:
                raise ShardCorruption(
                    f"manifest at step {step} missing leaf {name!r}")
            shape = tuple(ent["shape"])
            if tuple(like.shape) != shape:
                raise ValueError(
                    f"leaf {name!r}: checkpoint shape {shape} != "
                    f"target {tuple(like.shape)}")
            out[name] = self._typed(
                self._assemble(sd, name, ent, _whole(shape), {}, stats),
                ent["dtype"])
        self.last_restore_stats = dict(stats)
        return out

    @staticmethod
    def _typed(block: np.ndarray, dtype: str):
        """Host block in its logical dtype: a tensor for dtypes numpy
        lacks (bfloat16), else the numpy array."""
        if dtype in _RAW:
            return torch.from_numpy(np.ascontiguousarray(block)).view(
                _RAW[dtype][1])
        return block

    @staticmethod
    def _fill(tree, prefix: str, blocks: dict):
        """Write the blocks into ``tree``'s tensor leaves (in place) and
        return the tree, numpy leaves replaced by new arrays of their
        target's dtype."""
        def one(path, like):
            block = blocks[prefix + leaf_name(path)]
            if isinstance(like, torch.Tensor):
                with torch.no_grad():
                    like.copy_(_as_torch(block))
                return like
            arr = (block.float().numpy() if isinstance(block, torch.Tensor)
                   else block)
            want = np.dtype(getattr(like, "dtype", arr.dtype))
            return arr if arr.dtype == want else arr.astype(want)
        return tree_map(one, tree)

    def read_slice(self, step: int, name: str,
                   bounds: Sequence[Sequence[int]] | None = None
                   ) -> np.ndarray:
        """Verified read of one leaf slice — the streaming primitive:
        opens only shard files overlapping ``bounds`` ([[start, stop],
        ...]; None = whole leaf).  A bfloat16 leaf comes back as
        float32 (exact; numpy has no bfloat16).  Read accounting lands
        in ``last_restore_stats``."""
        sd = self.step_path(step)
        ent = self._read_manifest(sd)["leaves"].get(name)
        if ent is None:
            raise ShardCorruption(
                f"manifest at step {step} missing leaf {name!r}")
        shape = tuple(ent["shape"])
        bounds = (_whole(shape) if bounds is None
                  else [list(map(int, b)) for b in bounds])
        stats = {"files_read": 0, "bytes_read": 0}
        out = self._assemble(sd, name, ent, bounds, {}, stats)
        self.last_restore_stats = stats
        out = self._typed(out, ent["dtype"])
        return out.float().numpy() if isinstance(out, torch.Tensor) \
            else out

    def restore_extra(self, step: int | None = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.directory}")
        return self._read_manifest(self.step_path(step)).get(
            "extra", {}) or {}

    def close(self) -> None:
        pass

    # -- verified assembly ----------------------------------------

    def _read_manifest(self, sd: Path) -> dict:
        p = sd / MANIFEST
        try:
            st = p.stat()
        except FileNotFoundError:
            self._manifest_cache.pop(sd.name, None)
            raise ShardCorruption(
                f"uncommitted generation (no manifest): {sd.name}")
        key = (st.st_mtime_ns, st.st_size)
        hit = self._manifest_cache.get(sd.name)
        if hit is not None and hit[0] == key:
            return hit[1]
        try:
            m = json.loads(p.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ShardCorruption(
                f"garbled manifest in {sd.name}: {e}") from e
        if m.get("format") != FORMAT:
            raise ShardCorruption(
                f"unknown manifest format {m.get('format')!r} "
                f"in {sd.name}")
        self._manifest_cache[sd.name] = (key, m)
        return m

    def _assemble(self, sd: Path, name: str, ent: dict, bounds,
                  cache: dict, stats: dict) -> np.ndarray:
        """The ``bounds`` slice of a leaf, in its storage dtype, from
        the shards that intersect it (each verified on read)."""
        dtype = _storage_dtype(ent["dtype"])
        lo = [b[0] for b in bounds]
        hi = [b[1] for b in bounds]
        out_shape = tuple(h - l for l, h in zip(lo, hi))
        want = int(np.prod(out_shape, dtype=np.int64)) \
            if out_shape else 1
        hits = []
        for sh in ent["shards"]:
            sb = sh["bounds"]
            inter = [(max(l, s0), min(h, s1))
                     for l, h, (s0, s1) in zip(lo, hi, sb)]
            if not any(a >= b for a, b in inter):
                hits.append((sh, inter))
        if (len(hits) == 1 and hits[0][0]["bounds"] == [list(b) for b in
                                                        bounds]):
            # one shard is exactly the slice: no copy
            sh = hits[0][0]
            return self._shard_data(sd, sh, dtype, out_shape, cache,
                                    stats, name)
        out = np.empty(out_shape, dtype)
        covered = 0
        for sh, inter in hits:
            sb = sh["bounds"]
            sshape = tuple(s1 - s0 for s0, s1 in sb)
            data = self._shard_data(sd, sh, dtype, sshape, cache,
                                    stats, name)
            src = tuple(slice(a - s0, b - s0)
                        for (a, b), (s0, _) in zip(inter, sb))
            dst = tuple(slice(a - l, b - l)
                        for (a, b), l in zip(inter, lo))
            out[dst] = data[src]
            covered += int(np.prod(
                [b - a for a, b in inter], dtype=np.int64)) \
                if inter else 1
        if covered != want:
            raise ShardCorruption(
                f"leaf {name!r}: shards cover {covered}/{want} "
                f"elements of the requested slice")
        return out

    def _shard_data(self, sd: Path, sh: dict, dtype: np.dtype,
                    sshape, cache: dict, stats: dict,
                    name: str) -> np.ndarray:
        fname = sh["file"]
        if fname in cache:
            return cache[fname]
        path = sd / fname
        if not path.exists():
            raise ShardCorruption(
                f"leaf {name!r}: missing shard file {fname}")
        raw = np.fromfile(path, dtype=np.uint8)
        stats["files_read"] += 1
        stats["bytes_read"] += raw.nbytes
        if raw.nbytes != sh["nbytes"]:
            raise ShardCorruption(
                f"shard {fname}: truncated "
                f"({raw.nbytes} != {sh['nbytes']} bytes)")
        if self.verify and (zlib.crc32(raw) & 0xFFFFFFFF) != sh["crc32"]:
            raise ShardCorruption(f"shard {fname}: checksum mismatch")
        arr = raw.view(dtype).reshape(sshape)
        cache[fname] = arr
        return arr


__all__ = ["FORMAT", "MANIFEST", "ShardCorruption",
           "ShardedCheckpointer", "adamw_leaves", "decode_spec",
           "encode_spec", "leaf_name", "load_adamw_leaves",
           "match_partition_rules", "tree_flatten_with_path",
           "tree_leaf_names"]
