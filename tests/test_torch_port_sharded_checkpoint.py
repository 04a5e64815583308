"""The sharded checkpoint (``horovod_tpu_torch/api/sharded_checkpoint.py``)
on the CPU, against the JAX package's ``ShardedCheckpointer``.

One 2-rank and one 4-rank gloo world (``tests/torch_port_ckpt_util.py``
``ckpt_worker``) run while the reference works in this process over its
8 CPU devices:

* **Reference to port.**  The reference saves ``P("world")`` rows,
  ``P()`` and ``P(None, "world")`` (float32 and int32) over its 8
  devices; each world restores that step onto other placements (rows by
  columns, the replicated vector by rows, the column-sharded ints
  replicated), bitwise.
* **The reference's own cases** (``tests/test_sharded_checkpoint.py``) in
  both worlds: round trip, another sharding, a missing leaf, a re-save
  that drops stale pieces, a step without ``meta.json``, a host leaf
  written once by rank 0; and a torn piece that fails ``verify_step``
  and counts once in ``hvtpu_ckpt_verify_failures_total``.
* **Port to reference.**  The 4-rank world saves a 2-layer float32
  transformer at tp=2 x dp=2 (``models.transformer.global_params``) with
  a bfloat16 leaf sharded over dp; the reference saves the same global
  tree over 4 of its devices at the same layout.  ``meta.json`` is the
  same, and every leaf's pieces are the same set of (slices, sha256,
  bytes): the same files but for their names.  The reference restores the
  port's float32 step onto its 8 devices, bitwise.
* **bfloat16.**  The port restores its bfloat16 leaf bitwise (subnormal,
  inf and NaN bits included) onto another placement, in both worlds;
  the reference's ``restore`` raises ``ValueError`` on the same step (it
  assigns the loaded ``|V2`` piece into a ``bfloat16`` buffer, and numpy
  has no cast between them).

Everything is compared bitwise: a checkpoint moves bytes.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_port_ckpt_util import (
    BF16_SHAPE,
    REF_LEAVES,
    REF_RESTORE_DIMS,
    REF_STEP,
    TFM_LAYOUT,
    TFM_SMALL,
    TFM_STEP,
    bf16_bits,
    block,
    ckpt_worker,
    ref_arrays,
    tfm_global,
)
from torch_port_util import join_world, start_world
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

WORLDS = (2, 4)
REF_SPECS = {"rows": P("world"), "repl": P(), "cols": P(None, "world")}


def _ref_tfm_tree(layout):
    """The reference's tree of the same global arrays as the port's
    ``tfm_tree``, each a global array at the same layout."""
    from horovod_tpu.models import transformer as ref_tfm

    cfg = ref_tfm.TransformerConfig(**TFM_SMALL, dtype=jnp.float32)
    specs = ref_tfm.param_specs(cfg, layout)
    glob = tfm_global()
    params = {}
    for name, a in glob.items():
        *path, leaf = name.split(".")
        node, spec = params, specs
        for key in path:
            node, spec = node.setdefault(key, {}), spec[key]
        node[leaf] = jax.device_put(a, NamedSharding(layout.mesh,
                                                     spec[leaf]))
    bits = bf16_bits().view(ml_dtypes.bfloat16)
    return glob, {"params": params, "bf16": {"w": jax.device_put(
        bits, NamedSharding(layout.mesh, P(layout.dp)))}}


def _pieces(step_dir) -> dict:
    """key -> sorted [(slices, sha256, bytes)] over every manifest."""
    out = {}
    for name in os.listdir(step_dir):
        if name.startswith("manifest_"):
            with open(os.path.join(step_dir, name)) as f:
                for key, entries in json.load(f).items():
                    out.setdefault(key, []).extend(
                        (json.dumps(e["slices"]), e["sha256"], e["bytes"])
                        for e in entries)
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import horovod_tpu as hvt
    from horovod_tpu import ShardedCheckpointer as RefCkpt
    from horovod_tpu import parallel as ref_par

    root = tmp_path_factory.mktemp("sckpt")
    hvt.init()
    try:
        mesh = hvt.world_mesh()
        raw = ref_arrays()
        tree = {k: jax.device_put(raw[k], NamedSharding(mesh, REF_SPECS[k]))
                for k in REF_LEAVES}
        RefCkpt(str(root / "ref_ckpt")).save(REF_STEP, tree)
        dirs = {}
        for world in WORLDS:
            dirs[world] = root / f"w{world}"
            dirs[world].mkdir()
            shutil.copytree(root / "ref_ckpt", dirs[world] / "ref_ckpt")
        handles = {w: start_world(ckpt_worker, w, dirs[w]) for w in WORLDS}

        layout = ref_par.make_layout(jax.devices()[:4], **TFM_LAYOUT)
        glob, ref_tree = _ref_tfm_tree(layout)
        RefCkpt(str(root / "ref_tfm")).save(TFM_STEP, ref_tree)

        out = {}
        for world, handle in handles.items():
            codes, infos = join_world(handle, timeout=240)
            assert codes == [0] * world, (world, codes)
            out[world] = [(dict(np.load(dirs[world] / f"ckpt{r}.npz")),
                           infos[r]) for r in range(world)]

        # the reference restores the port's step onto its 8 devices
        port_dir = str(dirs[4] / "port_tfm")
        template = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(
                a.shape, a.dtype, sharding=NamedSharding(
                    mesh, P("world") if a.shape[0] % 8 == 0 else P())),
            {"params": ref_tree["params"]})
        restored = jax.tree.map(
            np.asarray, RefCkpt(port_dir).restore(template, step=TFM_STEP))
        bf16_like = {"bf16": {"w": jax.ShapeDtypeStruct(
            BF16_SHAPE, jnp.bfloat16, sharding=NamedSharding(mesh, P()))}}
        try:
            RefCkpt(port_dir).restore(bf16_like, step=TFM_STEP)
            ref_bf16_error = None
        except ValueError as e:
            ref_bf16_error = str(e)
    finally:
        hvt.shutdown()
    return dict(out=out, raw=raw, glob=glob, restored=restored,
                ref_bf16_error=ref_bf16_error, root=root, dirs=dirs)


@pytest.mark.parametrize("world", WORLDS)
def test_reference_step_restores_onto_other_placements(run, world):
    for rank, (arrays, info) in enumerate(run["out"][world]):
        assert info["ref_latest"] == REF_STEP and info["ref_verified"]
        for name, dim in REF_RESTORE_DIMS.items():
            got = arrays[f"ref/{name}"]
            want = block(run["raw"][name], dim, rank, world)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (world, rank, name)


@pytest.mark.parametrize("world", WORLDS)
def test_reference_cases_on_the_port(run, world):
    for rank, (_, info) in enumerate(run["out"][world]):
        assert info["roundtrip_steps"] == [3] and info["roundtrip_ok"]
        assert info["resharded_ok"], rank
        assert info["missing_leaf"].startswith("KeyError") \
            and "extra" in info["missing_leaf"]
        assert info["resave_ok"], rank
        assert "manifest_p9.json" not in info["resave_files"]
        assert info["uncommitted_steps"] == [0, 1, 3]
        assert info["uncommitted_latest"] == 3
        host = {int(r): v for r, v in info["host_entries"].items()}
        assert len(host[0]) == 1 and all(not host[r] for r in range(1, world))
        assert info["host_counter"] == 42           # rank 0's value
        assert info["verify_before"] is True
        assert info["verify_torn"] is False
        assert info["verify_failures_counted"] == 1.0


def test_port_save_matches_the_reference_save(run):
    port_dir = run["dirs"][4] / "port_tfm" / f"step_{TFM_STEP:012d}"
    ref_dir = run["root"] / "ref_tfm" / f"step_{TFM_STEP:012d}"
    with open(port_dir / "meta.json") as f:
        port_meta = json.load(f)
    with open(ref_dir / "meta.json") as f:
        ref_meta = json.load(f)
    assert port_meta == ref_meta
    assert any(leaf["dtype"] == "bfloat16" for leaf in port_meta["leaves"])
    port_pieces, ref_pieces = _pieces(port_dir), _pieces(ref_dir)
    assert port_pieces.keys() == ref_pieces.keys()
    for key in ref_pieces:
        assert port_pieces[key] == ref_pieces[key], key
    # each rank wrote only its own shards (4 manifests, no replica twice)
    assert sorted(p for p in os.listdir(port_dir)
                  if p.startswith("manifest_")) == [
        f"manifest_p{r}.json" for r in range(4)]


def test_reference_restores_the_port_step(run):
    from horovod_tpu_torch.models.transformer import flatten

    got = flatten(run["restored"]["params"])
    assert got.keys() == run["glob"].keys()
    for name, want in run["glob"].items():
        assert got[name].dtype == want.dtype
        assert np.array_equal(got[name], want), name


@pytest.mark.parametrize("world", WORLDS)
def test_bfloat16_round_trips_bitwise(run, world):
    bits = bf16_bits()
    for rank, (arrays, info) in enumerate(run["out"][world]):
        assert info["bf16_dtype"] == "torch.bfloat16"
        # restored column-sharded: this rank's block of columns
        want = block(bits, 1, rank % 2 if world == 4 else rank,
                     2 if world == 4 else world)
        assert np.array_equal(arrays["bf16/local"], want), (world, rank)


def test_reference_cannot_restore_bfloat16(run):
    """The recorded fault of the reference: the same step's bfloat16 leaf
    raises in its restore, where the port restores it bitwise."""
    assert run["ref_bf16_error"] is not None
    assert "No cast function available" in run["ref_bf16_error"]
