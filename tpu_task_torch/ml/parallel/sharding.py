"""Logical-axis rules, regex-over-path rules and the per-rank shard cut —
the counterpart of ``tpu_task/ml/parallel/sharding.py``.

Model code annotates its parameters with LOGICAL axis names
(``transformer.param_logical_axes``); :data:`DEFAULT_RULES` maps them to
mesh axes; :func:`match_partition_rules` resolves a :class:`PartitionSpec`
for every leaf of a tree from those annotations or from regex rules over
its "/"-joined path (the paged pools), scalars replicated and an unmatched
leaf an error that names it. Mesh axes absent from the mesh drop to None,
so one table serves every mesh shape. These are the JAX module's, word for
word, and give JAX's specs.

Placement differs: a JAX program sees the whole array and XLA places its
shards; a rank of the port's gang holds only its own shard.
:func:`device_put_tree` cuts each leaf's slice for one rank (contiguous,
its own tensor) out of a full tree held in host memory and moves only that
slice to the rank's device, so a full tree never sits on the device once a
rank. The JAX module's compile seam (``PartitionPlan``, ``compile_step``)
has its counterpart in the gang's program broadcast
(:mod:`~tpu_task_torch.ml.parallel.gang`)."""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# logical axis -> mesh axis (or None = replicate).
# fsdp shards the "long" parameter axis; tp shards heads/mlp.
DEFAULT_RULES: Dict[str, Optional[object]] = {
    # Activation batch spans every data axis present in the mesh; "ep"
    # counts as one (expert-parallel meshes shard tokens over ep so the
    # dense compute between MoE layers parallelizes too — only the expert
    # weights and the all_to_all dispatch treat ep specially).
    "batch": ("dp", "fsdp", "ep"),
    "seq": None,               # sequence replicated (ring attention uses "sp")
    "vocab": "tp",
    "embed": "fsdp",
    "heads": "tp",
    "head_dim": None,
    "kv": None,
    "mlp": "tp",
    "norm": None,
    "expert": "ep",
}


class PartitionSpec(tuple):
    """One entry a dimension: a mesh axis name, a tuple of them, or None
    (replicated). A tuple, so it compares equal to JAX's
    ``PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def logical_to_mesh_axes(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Dict[str, Optional[object]]] = None,
    mesh=None,
) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec.

    Mesh axes not present in ``mesh`` (when given) are dropped to None so the
    same model code runs on meshes without e.g. an ``ep`` axis.
    """
    rules = DEFAULT_RULES if rules is None else rules
    mesh_axis_names = set(mesh.axis_names) if mesh is not None else None

    def resolve(name: Optional[str]):
        if name is None:
            return None
        target = rules.get(name)
        if target is None:
            return None
        if isinstance(target, tuple):
            if mesh_axis_names is not None:
                target = tuple(t for t in target if t in mesh_axis_names)
            return target if target else None
        if mesh_axis_names is not None and target not in mesh_axis_names:
            return None
        return target

    return PartitionSpec(*(resolve(a) for a in logical_axes))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _map(fn: Callable, tree, is_leaf: Callable, path: Tuple = ()):
    """``tree``'s structure (dicts, lists, tuples) with ``fn(path, leaf)``
    at each leaf, ``path`` the keys and indices down to it."""
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def logical_tree_pspecs(axes_tree, mesh=None, rules=None):
    """A whole tree of logical-axis tuples → a tree of PartitionSpecs,
    the annotated half of rule resolution."""
    return _map(lambda _, a: logical_to_mesh_axes(a, rules=rules, mesh=mesh),
                axes_tree, _is_axes)


def mesh_axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``, 1 when the mesh is None or lacks the
    axis — the one resolution every consumer of an OPTIONAL mesh axis
    shares (the serving engine reads its tp and ep widths through this,
    so a tp-only mesh, an ep-only mesh, and a tp×ep gang all resolve
    consistently)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(name, 1))


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the logical "batch" dim shards over, normalized to a
    (possibly empty) tuple."""
    resolved = logical_to_mesh_axes(("batch",), mesh=mesh)[0]
    if resolved is None:
        return ()
    if isinstance(resolved, tuple):
        return resolved
    return (resolved,)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one PartitionSpec entry names, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a PartitionSpec shards over, in its order."""
    return tuple(a for entry in (spec or ()) for a in entry_axes(entry))


# -- regex-over-path rule resolution ------------------------------------------

def tree_path_str(path) -> str:
    """A path of keys and indices as a "/"-joined name (``layers/0/wq``):
    the format regex partition rules match against."""
    return "/".join(str(key) for key in path)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def match_partition_rules(rules, tree, mesh=None, logical_axes=None,
                          logical_rules=None):
    """Resolve a PartitionSpec for every array leaf of ``tree``.

    Per leaf (its path "/"-joined, e.g. ``layers/0/wq`` or ``0/k``),
    resolution order:

    1. scalar leaves (0-d or single-element) replicate:
       ``PartitionSpec()``;
    2. a **logical-axis annotation** (``logical_axes``, a matching tree of
       logical-axis tuples) wins over any regex;
    3. else the FIRST entry of ``rules`` whose regex ``re.search``-matches
       the path wins. ``rules`` is a sequence of ``(pattern, target)``
       where ``target`` is either a tuple of LOGICAL axis names (resolved
       through the same table as annotations) or a raw ``PartitionSpec``
       (mesh axes used verbatim);
    4. nothing matched → ``ValueError`` naming the offending path, so a
       new parameter cannot silently replicate.

    Mesh axes absent from ``mesh`` drop to None in every case."""
    rules = tuple(rules or ())
    annotations: Dict[str, Any] = {}
    if logical_axes is not None:
        def note(path, axes):
            annotations[tree_path_str(path)] = axes
        _map(note, logical_axes, lambda x: _is_axes(x) or x is None)

    def resolve(path, leaf):
        name = tree_path_str(path)
        shape = _leaf_shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return PartitionSpec()
        axes = annotations.get(name)
        if axes is not None:
            return logical_to_mesh_axes(axes, rules=logical_rules, mesh=mesh)
        for pattern, target in rules:
            if re.search(pattern, name):
                if isinstance(target, PartitionSpec):
                    return filter_spec(target, mesh)
                return logical_to_mesh_axes(target, rules=logical_rules,
                                            mesh=mesh)
        raise ValueError(
            f"no partition rule matched param {name!r} "
            f"(shape {shape}); add a regex rule "
            f"or a logical-axis annotation for it")

    return _map(resolve, tree, lambda x: hasattr(x, "shape"))


def filter_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop mesh axes absent from ``mesh`` out of a raw PartitionSpec —
    the same missing-axis contract logical resolution has."""
    if mesh is None:
        return spec
    names = set(mesh.axis_names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return PartitionSpec(*(fix(e) for e in spec))


# -- the per-rank cut ----------------------------------------------------------

def shard_slices(shape: Sequence[int], spec: Sequence, mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The block of an array of ``shape`` that ``rank`` (default: the
    mesh's own) holds under ``spec``: each dimension named by mesh axes
    cuts into as many equal contiguous pieces as those axes have
    positions (several axes: row-major over them) and the rank takes the
    piece at its coordinates. A dimension that does not divide raises."""
    coords = mesh.coords(rank)
    out = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        size = int(shape[dim])
        axes = entry_axes(entry)
        pieces, index = 1, 0
        for axis in axes:
            n = int(dict(mesh.shape).get(axis, 1))
            pieces, index = pieces * n, index * n + coords.get(axis, 0)
        if size % pieces:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over mesh axes {axes} ({pieces})")
        step = size // pieces
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def _spec_leaf(x) -> bool:
    return isinstance(x, PartitionSpec) or x is None


def _zip_specs(fn: Callable, tree, pspec_tree):
    """``fn(leaf, spec)`` over ``tree`` and the matching spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, pspec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _spec_leaf(pspec_tree):
        return type(tree)(_zip_specs(fn, v, s)
                          for v, s in zip(tree, pspec_tree))
    return fn(tree, pspec_tree)


def spec_leaves(pspec_tree) -> List[PartitionSpec]:
    """The PartitionSpecs of a spec tree in ``jax.tree.leaves`` order (a
    PartitionSpec is one leaf, as in JAX, not a tuple to walk)."""
    from tpu_task_torch.ml.tree import leaves

    return leaves(pspec_tree, is_leaf=lambda x: isinstance(x,
                                                           PartitionSpec))


def global_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The whole array's shape of a block of ``shape`` that a rank holds
    under ``spec``: each dimension times its pieces."""
    entries = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    out = []
    for size, entry in zip(shape, entries):
        for axis in entry_axes(entry):
            size *= int(dict(mesh.shape).get(axis, 1))
        out.append(int(size))
    return tuple(out)


def writes_block(spec, mesh, rank: Optional[int] = None) -> bool:
    """Whether ``rank`` (default: the mesh's own) is the one copy of its
    block under ``spec``: index 0 along every mesh axis the spec does not
    name, JAX's ``replica_id == 0``."""
    named = set(spec_axes(spec))
    return all(i == 0 for axis, i in mesh.coords(rank).items()
               if axis not in named)


def shard_leaf(leaf, spec, mesh, rank: Optional[int] = None,
               device=None) -> torch.Tensor:
    """``rank``'s block of one full leaf (a numpy array or a tensor), as a
    contiguous tensor of its own on ``device`` (default: the mesh's)."""
    tensor = (torch.from_numpy(np.ascontiguousarray(leaf))
              if isinstance(leaf, np.ndarray) else leaf)
    block = tensor[shard_slices(tensor.shape, spec or (), mesh, rank)]
    return block.contiguous().to(mesh.device if device is None else device)


def device_put_tree(tree, pspec_tree, mesh, rank: Optional[int] = None,
                    device=None):
    """Every leaf of the full ``tree`` cut to ``rank``'s block under the
    matching PartitionSpec leaf (:func:`shard_leaf`) and placed on
    ``device`` (default: the mesh's): the one placement the serving
    engine's params and the gang's shipped slices share. The full leaves
    stay where they are; only the slices move."""
    return _zip_specs(
        lambda leaf, spec: shard_leaf(leaf, spec, mesh, rank, device),
        tree, pspec_tree)


#: The JAX package's other name for :func:`device_put_tree`.
shard_pytree = device_put_tree


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    from tpu_task_torch.ml.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


__all__: List[str] = [
    "DEFAULT_RULES", "PartitionSpec", "device_put_tree", "entry_axes",
    "filter_spec",
    "logical_to_mesh_axes", "logical_tree_pspecs", "match_partition_rules",
    "mesh_axis_size", "mesh_batch_axes", "shard_leaf", "shard_pytree",
    "global_shape", "shard_slices", "spec_axes", "spec_leaves",
    "tree_nbytes", "tree_path_str", "writes_block",
]
