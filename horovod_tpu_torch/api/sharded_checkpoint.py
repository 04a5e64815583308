"""Pod-scale sharded checkpointing: every process writes its shards.

Counterpart of ``horovod_tpu/api/sharded_checkpoint.py``, with its
methods and its on-disk layout.  A global array is a
``torch.distributed.tensor.DTensor`` over a ``DeviceMesh`` (PyTorch's
form of a ``jax.Array`` with a ``NamedSharding``): each process writes
only its own block of each one, with a manifest of the global slices
each piece covers; restore rebuilds every leaf onto the TEMPLATE's mesh
and placements, which may differ from the saver's (another world size,
another layout), by assembling this rank's block from the intersecting
saved pieces.

Layout of one step directory::

    step_000000000042/
      meta.json           # leaf paths, shapes, dtypes (rank 0)
      manifest_p{K}.json  # process K's pieces: key -> [{file, slices,
                          #   sha256, bytes}]
      pieces/{key}.p{K}.{j}.npy

A leaf's path is ``jax.tree_util.keystr``'s (``['blocks']['wqkv']``,
``[0]``) over dicts (keys sorted, as JAX flattens them), lists and
tuples; its key is the reference's ``_leaf_key``.

Placements: ``Shard(d)`` on a mesh dimension partitions tensor dim ``d``
over it (several mesh dimensions on one ``d``: the earlier one outer, as
a tuple of axes in a ``PartitionSpec``); ``Replicate()`` is an axis the
spec does not name.  A rank's slice comes from ``mesh.get_coordinate()``
and the placements; a dim that its axes do not divide is refused.  A
replicated block is written once: by the rank whose coordinate is 0 on
every mesh dimension that replicates it (the reference's
``replica_id == 0``).  Host leaves (plain tensors, numpy arrays,
scalars) take rank 0's value, written once.

bfloat16 pieces are raw 2-byte ``<V2`` arrays, the bytes ``np.save``
writes for the reference's ``ml_dtypes`` leaves; restore reads them back
as ``torch.bfloat16`` bit for bit.  (The reference's own ``restore``
cannot: it assigns the loaded ``|V2`` piece into a ``bfloat16`` buffer,
and numpy has no cast between the two.)

The write is collective and ``meta.json`` is the COMMIT MARKER: rank 0
clears any stale content of the step directory first, every rank writes
its pieces, and only after a barrier does rank 0 write ``meta.json``, so
a step without it (a rank died mid-save) is invisible to
``all_steps`` / ``latest_step``.  The collectives are barriers only
(``comm/eager.py``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import durable as core_durable
from ..core import state as core_state
from .checkpoint import list_steps, step_dir_name

# dtype names of meta.json (numpy's, as the reference writes them)
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _leaf_key(path_str: str) -> str:
    """Filesystem-safe stable name for a tree path."""
    h = hashlib.sha1(path_str.encode()).hexdigest()[:12]
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", path_str)[:48]
    return f"{safe}.{h}"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` of every leaf, in JAX's flattening order:
    dict keys sorted, list and tuple items in order, ``None`` no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_path(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(leaves_with_path(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, map_with_path(fn, v, f"{prefix}[{k!r}]"))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [map_with_path(fn, v, f"{prefix}[{i}]")
                 for i, v in enumerate(tree)]
        return type(tree)(items) if not hasattr(tree, "_fields") \
            else type(tree)(*items)
    return fn(prefix, tree)


def shard_slices(shape: Sequence[int], mesh, placements
                 ) -> Tuple[List[List[int]], bool]:
    """This rank's ``[[start, stop], ...]`` of a global array of ``shape``
    under ``placements`` on ``mesh``, and whether this rank writes it
    (coordinate 0 on every mesh dimension that replicates it)."""
    from torch.distributed.tensor import Replicate, Shard

    coord = mesh.get_coordinate()
    sizes = list(mesh.shape)
    names = mesh.mesh_dim_names or tuple(range(len(sizes)))
    slices = [[0, int(d)] for d in shape]
    blocks = [(0, 1)] * len(shape)          # (index, count) a tensor dim
    writer = True
    for m, p in enumerate(placements):
        if isinstance(p, Replicate):
            writer = writer and coord[m] == 0
        elif isinstance(p, Shard):
            i, n = blocks[p.dim]
            blocks[p.dim] = (i * sizes[m] + coord[m], n * sizes[m])
        else:
            raise ValueError(f"placement {p} on mesh dim {names[m]!r}: "
                             "only Shard and Replicate are saved")
    for d, (i, n) in enumerate(blocks):
        if n == 1:
            continue
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} not divisible "
                             f"by the {n} shards of its mesh axes")
        size = shape[d] // n
        slices[d] = [i * size, (i + 1) * size]
    return slices, writer


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy of ``t``; bfloat16 as raw 2-byte void elements."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _npy_bytes(data: np.ndarray) -> bytes:
    """``np.save``'s bytes; a bfloat16 piece (``V2``) under the descr
    ``<V2`` that ``np.save`` gives the reference's ``ml_dtypes`` arrays."""
    buf = io.BytesIO()
    if data.dtype == np.dtype("V2"):
        np.lib.format.write_array_header_1_0(buf, {
            "descr": "<V2", "fortran_order": False,
            "shape": tuple(data.shape)})
        buf.write(np.ascontiguousarray(data).tobytes())
    else:
        np.save(buf, data)
    return buf.getvalue()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    # np.ascontiguousarray would make a 0-d array 1-d
    a = a if a.flags.c_contiguous else a.copy()
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _host_value(leaf) -> Tuple[np.ndarray, str]:
    """(numpy value, dtype name) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(leaf), _DTYPE_NAMES[leaf.dtype]
    val = np.asarray(leaf)
    return val, str(val.dtype)


class ShardedCheckpointer:
    """Distributed save/restore of trees of ``DTensor``s."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, step_dir_name(step))

    @staticmethod
    def _barrier(st):
        if st.size > 1:
            from ..comm import eager as eager_comm

            eager_comm.barrier()

    # -- write side ----------------------------------------------------
    def save(self, step: int, tree) -> None:
        st = core_state.require_init("sharded checkpointing")
        pid = st.rank
        target = self._step_dir(step)
        pieces_dir = os.path.join(target, "pieces")

        # 1. rank 0 clears any stale content (a re-save of this step by
        #    a smaller world must not leave the old world's pieces to be
        #    blended in at restore), then everyone waits
        if st.rank == 0:
            shutil.rmtree(target, ignore_errors=True)
            os.makedirs(pieces_dir, exist_ok=True)
        self._barrier(st)
        os.makedirs(pieces_dir, exist_ok=True)

        # 2. every rank writes its pieces and an atomically renamed
        #    manifest
        manifest: Dict[str, List[dict]] = {}
        meta = {"leaves": []}
        for path_str, leaf in leaves_with_path(tree):
            key = _leaf_key(path_str)
            if _is_dtensor(leaf):
                shape, dtype = tuple(leaf.shape), _DTYPE_NAMES[leaf.dtype]
                slices, writer = shard_slices(shape, leaf.device_mesh,
                                              leaf.placements)
                pieces = []
                if writer:
                    local = leaf.to_local()
                    want = tuple(b - a for a, b in slices)
                    if tuple(local.shape) != want:
                        raise ValueError(
                            f"{path_str}: local block {tuple(local.shape)}"
                            f" is not the slice {slices} of {shape}")
                    pieces = [(f"{key}.p{pid}.0.npy", _to_numpy(local),
                               slices)]
            else:
                # host leaf: rank 0's value, written once (every process
                # writing its own copy would make the restored value
                # depend on the manifests' merge order)
                val, dtype = _host_value(leaf)
                shape = val.shape
                pieces = []
                if st.rank == 0:
                    pieces = [(f"{key}.host.npy", val,
                               [[0, int(d)] for d in shape])]
            meta["leaves"].append({
                "path": path_str, "key": key,
                "shape": [int(d) for d in shape], "dtype": dtype,
            })
            entries = []
            for fname, data, slices in pieces:
                # serialize first so the manifest records the intended
                # hash and size: a torn piece then fails verify_step
                raw = _npy_bytes(data)
                core_durable.atomic_write(
                    os.path.join(pieces_dir, fname), raw,
                    detail=f"{fname}@step{step}")
                entries.append({
                    "file": fname, "slices": slices,
                    "sha256": hashlib.sha256(raw).hexdigest(),
                    "bytes": len(raw),
                })
            if entries:
                manifest[key] = entries
        core_durable.atomic_write(
            os.path.join(target, f"manifest_p{pid}.json"),
            json.dumps(manifest).encode(),
            detail=f"manifest_p{pid}@step{step}")

        # 3. a barrier, THEN the commit marker (itself fsync-then-rename:
        #    a torn marker must be impossible), then one more barrier so
        #    no rank returns before the marker exists
        self._barrier(st)
        if st.rank == 0:
            core_durable.atomic_write(
                os.path.join(target, "meta.json"),
                json.dumps(meta).encode(),
                detail=f"meta@step{step}")
        self._barrier(st)

    # -- read side -----------------------------------------------------
    def all_steps(self) -> List[int]:
        return list_steps(self.directory, require_file="meta.json")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> bool:
        """Integrity check of one step as THIS process sees it:
        ``meta.json`` parses, every manifest parses, and every piece
        matches its recorded sha256 and byte size (an entry without a
        ``sha256`` only needs its file).  A failure counts once toward
        ``hvtpu_ckpt_verify_failures_total``."""
        target = self._step_dir(step)
        try:
            with open(os.path.join(target, "meta.json")) as f:
                json.load(f)
            names = os.listdir(target)
        except (OSError, ValueError):
            core_durable.note_verify_failure()
            return False
        for name in sorted(names):
            if not (name.startswith("manifest_")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(target, name)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                core_durable.note_verify_failure()
                return False
            for entries in manifest.values():
                for e in entries:
                    p = os.path.join(target, "pieces", e["file"])
                    try:
                        with open(p, "rb") as f:
                            raw = f.read()
                    except OSError:
                        core_durable.note_verify_failure()
                        return False
                    if "sha256" in e and (
                            len(raw) != e.get("bytes")
                            or hashlib.sha256(raw).hexdigest()
                            != e["sha256"]):
                        core_durable.note_verify_failure()
                        return False
        return True

    def restore(self, template, *, step: Optional[int] = None):
        """Rebuild the saved tree onto ``template``'s layouts.

        ``template`` matches the saved structure; a ``DTensor`` leaf
        gives the mesh and placements to restore onto (its values are
        not read), any other leaf is restored as a host value (a tensor
        on the template's device, else a numpy array).  ``step`` is
        keyword-only, as the reference's; ``None`` means the latest
        committed step (``None`` is returned when there is none).
        """
        core_state.require_init("sharded checkpointing")
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        target = self._step_dir(step)
        with open(os.path.join(target, "meta.json")) as f:
            meta = json.load(f)
        by_path = {leaf["path"]: leaf for leaf in meta["leaves"]}

        pieces: Dict[str, List[dict]] = {}
        for name in sorted(os.listdir(target)):
            if not name.startswith("manifest_"):
                continue
            with open(os.path.join(target, name)) as f:
                for key, entries in json.load(f).items():
                    pieces.setdefault(key, []).extend(entries)

        def _restore_leaf(path_str: str, like):
            # a cache a leaf: piece files are leaf-scoped, and a
            # restore-wide cache would hold the process's share of the
            # whole checkpoint in host memory at once
            cache: Dict[str, np.ndarray] = {}

            def _piece(fname: str) -> np.ndarray:
                if fname not in cache:
                    cache[fname] = np.load(
                        os.path.join(target, "pieces", fname))
                return cache[fname]

            info = by_path.get(path_str)
            if info is None:
                raise KeyError(
                    f"checkpoint step {step} has no leaf {path_str!r}")
            shape = tuple(info["shape"])
            dtype_name = info["dtype"]
            np_dtype = (np.dtype(np.int16) if dtype_name == "bfloat16"
                        else np.dtype(dtype_name))
            entries = pieces.get(info["key"], [])

            def assemble(want: List[List[int]]) -> np.ndarray:
                out = np.empty([b - a for a, b in want], np_dtype)
                filled = 0
                for e in entries:
                    have = e["slices"]
                    inter = [[max(w[0], h[0]), min(w[1], h[1])]
                             for w, h in zip(want, have)]
                    if any(a >= b for a, b in inter):
                        continue
                    src = _piece(e["file"])[tuple(
                        slice(a - h[0], b - h[0])
                        for (a, b), h in zip(inter, have))]
                    if dtype_name == "bfloat16":
                        src = src.view(np.int16)
                    out[tuple(slice(a - w[0], b - w[0])
                              for (a, b), w in zip(inter, want))] = src
                    filled += src.size
                if filled < out.size:
                    raise ValueError(
                        f"saved pieces do not cover the requested region "
                        f"of {path_str!r} (have {filled} of {out.size} "
                        f"elements) — incomplete checkpoint?")
                return out

            if _is_dtensor(like):
                from torch.distributed.tensor import DTensor

                if tuple(like.shape) != shape:
                    raise ValueError(
                        f"{path_str}: template shape {tuple(like.shape)} "
                        f"!= saved {shape}")
                want, _ = shard_slices(shape, like.device_mesh,
                                       like.placements)
                local = _from_numpy(assemble(want), dtype_name).to(
                    like.to_local().device)
                return DTensor.from_local(local, like.device_mesh,
                                          like.placements, run_check=False,
                                          shape=torch.Size(shape),
                                          stride=like.stride())
            full = assemble([[0, d] for d in shape])
            if isinstance(like, torch.Tensor):
                return _from_numpy(full, dtype_name).to(like.device)
            if dtype_name == "bfloat16":
                return full.view(np.dtype("V2"))
            return full

        return map_with_path(_restore_leaf, template)

