"""Helpers of the sharded checkpoint's tests: the trees, the layouts and
the rank functions of the gloo worlds of
``tests/test_torch_port_sharded_checkpoint.py`` and
``tests/test_torch_port_sharded_state.py``.  Imports torch and the port
only, so a spawned rank starts without JAX."""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from torch_port_util import _write_result

# the reference's save, restored by the port: name -> (shape, dtype);
# saved over 8 devices as P("world") rows, P() and P(None, "world")
REF_LEAVES = {"rows": ((16, 8), np.float32), "repl": ((64,), np.float32),
              "cols": ((6, 16), np.int32)}
REF_STEP = 5
# the port's restore placements of them: (tensor dim sharded over the
# world mesh, or None for replicated)
REF_RESTORE_DIMS = {"rows": 1, "repl": 0, "cols": None}

TFM_SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 max_seq=32)
TFM_LAYOUT = dict(dp=2, tp=2)     # 4 ranks
TFM_STEP = 7
BF16_SHAPE = (8, 4)


def ref_arrays() -> dict:
    rng = np.random.RandomState(3)
    out = {}
    for name, (shape, dtype) in REF_LEAVES.items():
        a = rng.randn(*shape) * 100
        out[name] = a.astype(dtype)
    return out


def tfm_global(torch_dtype=torch.float32) -> dict:
    """The small transformer's global parameters as a flat dict of numpy
    float32 arrays (the seeded init)."""
    from horovod_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**TFM_SMALL, dtype=torch_dtype)
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    return {n: t.float().numpy() for n, t in tfm.flatten(tree).items()}


def bf16_bits() -> np.ndarray:
    """A bfloat16 array's raw bits (int16), with subnormals, inf, NaN."""
    rng = np.random.RandomState(11)
    bits = rng.randint(-2 ** 15, 2 ** 15, size=BF16_SHAPE).astype(np.int16)
    bits.flat[:4] = [0x0001, 0x7F80, 0x7FC1, -0x0080]
    return bits


def block(a: np.ndarray, dim, index: int, count: int) -> np.ndarray:
    """Block ``index`` of ``count`` equal blocks of ``a`` along ``dim``
    (the whole of ``a`` when ``dim`` is None)."""
    if dim is None:
        return a
    size = a.shape[dim] // count
    sl = [slice(None)] * a.ndim
    sl[dim] = slice(index * size, (index + 1) * size)
    return a[tuple(sl)]


def dtensor(a: torch.Tensor, mesh, placements):
    """A DTensor of the global ``a`` under ``placements`` on ``mesh``."""
    from torch.distributed.tensor import DTensor

    from horovod_tpu_torch.api.sharded_checkpoint import shard_slices

    slices, _ = shard_slices(a.shape, mesh, placements)
    local = a[tuple(slice(s, e) for s, e in slices)].clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=a.shape, stride=a.stride())


def _world_placement(dim):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if dim is None else Shard(dim)]


def _init(rank: int, world: int, store_path: str):
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    return hvd


def _error(fn) -> str:
    """The message of the ``KeyError`` / ``ValueError`` that ``fn``
    raises, "" when it raises none."""
    try:
        fn()
    except (KeyError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _reference_cases(hvd, rank: int, out_dir: str, res: dict) -> None:
    """The reference's own single-step cases (tests/test_sharded_checkpoint
    .py) in this world: round trip, another sharding, a missing leaf, a
    re-save that drops stale pieces, a step without meta.json, a host leaf
    written once by rank 0, a torn piece."""
    from horovod_tpu_torch import ShardedCheckpointer
    from horovod_tpu_torch.core import durable as core_durable

    mesh = hvd.world_mesh()
    world = hvd.size()
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    rows, repl = _world_placement(0), _world_placement(None)
    tree = {"w": dtensor(w, mesh, rows), "nested": {"b": dtensor(b, mesh,
                                                                 repl)}}
    d = os.path.join(out_dir, "cases")
    ckpt = ShardedCheckpointer(d)

    ckpt.save(3, tree)
    out = ckpt.restore(tree)
    res["roundtrip_steps"] = ckpt.all_steps()
    res["roundtrip_ok"] = (
        torch.equal(out["w"].to_local(), tree["w"].to_local())
        and torch.equal(out["nested"]["b"].to_local(), b))

    cols, brow = _world_placement(1), _world_placement(0)
    other = {"w": dtensor(torch.zeros(16, 8), mesh, cols),
             "nested": {"b": dtensor(torch.zeros(64), mesh, brow)}}
    out = ckpt.restore(other, step=3)
    res["resharded_ok"] = (
        out["w"].placements == tuple(cols)
        and torch.equal(out["w"].to_local(), block(w, 1, rank, world))
        and torch.equal(out["nested"]["b"].to_local(),
                        block(b, 0, rank, world)))

    res["missing_leaf"] = _error(
        lambda: ckpt.restore({**tree, "extra": tree["w"]}))

    # a re-save of a step clears what an earlier save of it left: an
    # orphan "process 9" manifest and piece covering every row
    w1 = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    ckpt.save(0, {"w": dtensor(w1, mesh, rows)})
    step_dir = os.path.join(d, "step_000000000000")
    if rank == 0:
        np.save(os.path.join(step_dir, "pieces", "orphan.p9.0.npy"),
                np.full((8, 4), -1.0, np.float32))
        with open(os.path.join(step_dir, "manifest_p0.json")) as f:
            key = next(iter(json.load(f)))
        with open(os.path.join(step_dir, "manifest_p9.json"), "w") as f:
            json.dump({key: [{"file": "orphan.p9.0.npy",
                              "slices": [[0, 8], [0, 4]]}]}, f)
    hvd.barrier()
    ckpt.save(0, {"w": dtensor(w1 + 100.0, mesh, rows)})
    out = ckpt.restore({"w": dtensor(torch.zeros(8, 4), mesh, rows)}, step=0)
    res["resave_ok"] = torch.equal(out["w"].to_local(),
                                   block(w1 + 100.0, 0, rank, world))
    res["resave_files"] = sorted(os.listdir(step_dir))

    # a half-written step 2: pieces, no commit marker
    ckpt.save(1, tree)
    if rank == 0:
        os.makedirs(os.path.join(d, "step_000000000002", "pieces"))
    hvd.barrier()
    res["uncommitted_steps"] = ckpt.all_steps()
    res["uncommitted_latest"] = ckpt.latest_step()
    hvd.barrier()

    # a host leaf: rank 0's value, written once
    host = {"w": tree["w"], "host_counter": np.int64(42 + rank)}
    ckpt.save(8, host)
    manifests = {}
    for r in range(world):
        with open(os.path.join(d, "step_000000000008",
                               f"manifest_p{r}.json")) as f:
            manifests[r] = [e["file"] for es in json.load(f).values()
                            for e in es if e["file"].endswith(".host.npy")]
    res["host_entries"] = manifests
    out = ckpt.restore(host, step=8)
    res["host_counter"] = int(np.asarray(out["host_counter"]))

    # a torn piece (rank 0 cuts rank world-1's) fails verify_step, counted
    # once a failed call
    ckpt.save(4, tree)
    res["verify_before"] = ckpt.verify_step(4)
    hvd.barrier()
    if rank == 0:
        pieces = os.path.join(d, "step_000000000004", "pieces")
        name = sorted(p for p in os.listdir(pieces)
                      if f".p{world - 1}." in p)[0]
        with open(os.path.join(pieces, name), "r+b") as f:
            f.truncate(os.path.getsize(f.name) - 3)
    hvd.barrier()
    before = core_durable._M_VERIFY_FAIL.value()
    res["verify_torn"] = ckpt.verify_step(4)
    res["verify_failures_counted"] = (core_durable._M_VERIFY_FAIL.value()
                                      - before)
    hvd.barrier()


def tfm_tree(hvd, torch_dtype=torch.float32):
    """(global params, the tree of DTensors) of the small transformer at
    ``TFM_LAYOUT``, plus a bfloat16 leaf sharded over dp."""
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm
    from torch.distributed.tensor import Replicate, Shard

    cfg = tfm.TransformerConfig(**TFM_SMALL, dtype=torch_dtype)
    lay = par.make_layout(**TFM_LAYOUT)
    glob = tfm_global()
    local = tfm.shard_params(
        {n: torch.from_numpy(a) for n, a in glob.items()}, cfg, lay)
    bits = torch.from_numpy(bf16_bits()).view(torch.bfloat16)
    tree = {"params": tfm.global_params(local, cfg, lay),
            "bf16": {"w": dtensor(bits, lay.mesh,
                                  [Replicate(), Shard(0), Replicate()])}}
    return glob, tree, lay


def ckpt_worker(rank: int, world: int, store_path: str,
                out_dir: str) -> None:
    """One rank of the sharded checkpoint's checks over gloo: the
    reference's step restored onto this world's placements (blocks to
    ``ckpt{rank}.npz``), the reference's own cases, and at 4 ranks the
    small transformer with a bfloat16 leaf saved at ``TFM_LAYOUT`` (for
    the reference to read) and its bfloat16 leaf restored onto another
    placement; in a world of 2, a bfloat16 round trip of its own."""
    from horovod_tpu_torch import ShardedCheckpointer
    from torch.distributed.tensor import Replicate, Shard

    hvd = _init(rank, world, store_path)
    mesh = hvd.world_mesh()
    res, arrays = {}, {}

    ckpt = ShardedCheckpointer(os.path.join(out_dir, "ref_ckpt"))
    res["ref_latest"] = ckpt.latest_step()
    res["ref_verified"] = ckpt.verify_step(REF_STEP)
    template = {}
    for name, (shape, dtype) in REF_LEAVES.items():
        zeros = torch.zeros(shape, dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype)
        template[name] = dtensor(zeros, mesh,
                                 _world_placement(REF_RESTORE_DIMS[name]))
    out = ckpt.restore(template, step=REF_STEP)
    for name, t in out.items():
        arrays[f"ref/{name}"] = t.to_local().numpy()

    _reference_cases(hvd, rank, out_dir, res)

    if world == 4:
        _, tree, lay = tfm_tree(hvd)
        ShardedCheckpointer(os.path.join(out_dir, "port_tfm")).save(
            TFM_STEP, tree)
        bits = torch.from_numpy(bf16_bits()).view(torch.bfloat16)
        like = {"bf16": {"w": dtensor(torch.zeros_like(bits), lay.mesh,
                                      [Replicate(), Replicate(), Shard(1)])}}
        got = ShardedCheckpointer(os.path.join(out_dir, "port_tfm")).restore(
            like, step=TFM_STEP)["bf16"]["w"]
        arrays["bf16/local"] = got.to_local().view(torch.int16).numpy()
        res["bf16_dtype"] = str(got.dtype)
    else:
        bits = torch.from_numpy(bf16_bits()).view(torch.bfloat16)
        d = ShardedCheckpointer(os.path.join(out_dir, "bf16_2"))
        d.save(1, {"w": dtensor(bits, mesh, [Shard(0)])})
        got = d.restore({"w": dtensor(torch.zeros_like(bits), mesh,
                                      [Shard(1)])})["w"]
        arrays["bf16/local"] = got.to_local().view(torch.int16).numpy()
        res["bf16_dtype"] = str(got.dtype)
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"ckpt{rank}.npz"), **arrays)
    _write_result(out_dir, rank, res)


# -- ShardedTorchState: commit in one world, sync in another ---------------------

STATE_LAYOUTS = {4: dict(dp=2, tp=2), 2: dict(pp=2), 1: {}}
STATE_COMMITS = 3          # commits a world; HVTPU_CKPT_KEEP=2 keeps two
STATE_KEEP = 2


def state_values(k: int) -> dict:
    """Commit ``k``'s global values: the transformer's parameters plus
    ``k``, Adam's first moment their negatives."""
    glob = tfm_global()
    return {"params": {n: a + k for n, a in glob.items()},
            "exp_avg": {n: -a - k for n, a in glob.items()}}


def _state_attrs(hvd, world: int, values: dict):
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**TFM_SMALL, dtype=torch.float32)
    lay = par.make_layout(**STATE_LAYOUTS[world])
    out = {}
    for attr, flat in values.items():
        local = tfm.shard_params(
            {n: torch.from_numpy(a.copy()) for n, a in flat.items()}, cfg,
            lay)
        out[attr] = tfm.global_params(local, cfg, lay)
    return cfg, lay, out


def state_worker(rank: int, world: int, store_path: str, out_dir: str,
                 state_dir: str, phase: str) -> None:
    """``phase`` "commit": ``STATE_COMMITS`` commits of a
    ``ShardedTorchState`` (the parameters and Adam's moment as DTensors at
    this world's layout, ``epoch`` and a per-rank ``note``), the last with
    ``state_values(STATE_COMMITS)``.  "sync": a fresh state of zeros at
    this world's layout syncs from ``state_dir``: its local blocks to
    ``state{rank}.npz``, then the audit of the replicated half, and a
    state without the array template that must refuse to sync."""
    os.environ["HVTPU_ELASTIC_STATE_DIR"] = state_dir
    os.environ["HVTPU_CKPT_KEEP"] = str(STATE_KEEP)
    hvd = _init(rank, world, store_path)
    from horovod_tpu_torch.core import audit as core_audit
    from horovod_tpu_torch.models import transformer as tfm

    res, arrays = {}, {}
    if phase == "commit":
        _, _, attrs = _state_attrs(hvd, world, state_values(0))
        state = hvd.elastic.ShardedTorchState(epoch=0, note=f"rank{rank}",
                                              **attrs)
        for k in range(1, STATE_COMMITS + 1):
            _, _, attrs = _state_attrs(hvd, world, state_values(k))
            state.params, state.exp_avg = attrs["params"], attrs["exp_avg"]
            state.epoch = k
            state.commit()
        hvd.barrier()      # rank 0 commits the replicated half after the rest
        res["sharded_steps"] = sorted(os.listdir(
            os.path.join(state_dir, "sharded")))
        from horovod_tpu_torch.core import durable as core_durable

        res["snapshots"] = core_durable.list_snapshots(state_dir)
    else:
        zeros = {a: {n: np.zeros_like(v) for n, v in flat.items()}
                 for a, flat in state_values(0).items()}
        _, lay, attrs = _state_attrs(hvd, world, zeros)
        state = hvd.elastic.ShardedTorchState(epoch=0, note="fresh",
                                              **attrs)
        state.sync()
        res["epoch"], res["note"] = state.epoch, state.note
        res["placements"] = {
            n: [str(p) for p in t.placements]
            for n, t in tfm.flatten(state.params).items()}
        for attr in ("params", "exp_avg"):
            for n, t in tfm.local_params(getattr(state, attr)).items():
                arrays[f"{attr}/{n}"] = t.numpy()
        os.environ["HVTPU_AUDIT_EVERY"] = "1"
        report = state.audit("sharded")
        res["audit_divergent"] = report["divergent"]
        # the shards themselves differ by rank: auditing them would be a
        # false divergence
        shards = core_audit.verify(tfm.local_params(state.params),
                                   "shards", action="warn")
        res["shards_divergent"] = bool(shards["divergent"])
        os.environ["HVTPU_AUDIT_EVERY"] = "0"
        bad = hvd.elastic.ShardedTorchState(params=None, epoch=0)
        res["missing_template"] = _error(bad.sync)
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"state{rank}.npz"), **arrays)
    _write_result(out_dir, rank, res)
