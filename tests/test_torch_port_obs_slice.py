"""The observability slice as a whole, and the repairs F3-F6 of the torch
surface, against the JAX package's torch frontend on the CPU.

* A world of one: the narrow ResNet trained for 2 steps through each
  package's ``DistributedOptimizer`` (Average, no codec, so no Pallas
  kernel runs) under ``HVTPU_TIMELINE`` and ``HVTPU_TRACE``: the same
  timeline spans (``NEGOTIATE_ALLREDUCE`` a gradient, one
  ``NCCL_ALLREDUCE`` / ``ICI_ALLREDUCE`` a group under the fused name)
  and the same trace span names a step, the same ``hvtpu_allreduce_total``,
  and parameters bitwise equal to the reference's and to the port's own
  with every plane off.  The reference's ``HVTPU_CYCLE_TIME`` is pinned
  so that it sends one group a step, as the port's bucket plan does for
  this model (``test_torch_port_frontend.py`` explains why).
* A 2-rank gloo world of the port (``torch_port_util.obs_worker``): the
  same span names a step on each rank as the reference's, the trace's
  clock handshake sets an offset on rank 1, ``metrics.aggregate`` returns
  ``merge_snapshots`` of both ranks, ``tools/hvtputrace`` merges the two
  files, an async burst is traced through NEGOTIATE, QUEUE, FUSE, EXEC
  and DONE, parameters bitwise with the planes on and off, and five
  differently named ops a mode (amortized, strict) each diagnosed as
  diverged, counted in the abort family and named in a postmortem (F4).
* F3 (``broadcast_object``'s ``name``), F5 (``op=Min|Max|Product`` in
  ``DistributedOptimizer``) and F6 (``grouped_allreduce``'s order), each
  against the reference's value.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.obs import metrics as port_metrics
from tools import hvtputrace
from torch_port_util import (OBS_KINDS, narrow_resnet, obs_worker,
                             spawn_world, synthetic_batches,
                             timeline_span_names, trace_span_names,
                             train_steps)

STEPS = 2
GROUP_CYCLE_MS = 5000


def _run(pkg, metrics, model, tmp, trace: bool):
    """``STEPS`` steps, one timeline file a step; returns the timeline
    span pairs a step, the allreduce count and the parameters."""
    opt = pkg.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    before = metrics.op_counter("allreduce").value()
    timelines = []
    metrics.note_step()
    for k, b in enumerate(synthetic_batches(STEPS, batch=4)):
        if trace:
            pkg.start_timeline(str(tmp / f"timeline{k}.json"))
        train_steps(model, opt, [b])
        metrics.note_step()
        if trace:
            pkg.stop_timeline()
            timelines.append(timeline_span_names(
                str(tmp / f"timeline{k}.json")))
    params = [p.detach().clone() for p in model.parameters()]
    return timelines, metrics.op_counter("allreduce").value() - before, \
        params


@pytest.fixture(scope="module")
def reference_slice(tmp_path_factory):
    """The JAX package's torch frontend, traced (world of one)."""
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd
    from horovod_tpu.obs import metrics as ref_metrics

    tmp = tmp_path_factory.mktemp("ref_slice")
    mp = pytest.MonkeyPatch()
    mp.setenv("HVTPU_FLIGHT_DIR", str(tmp))
    mp.setenv("HVTPU_TRACE", str(tmp / "trace"))
    mp.setenv("HVTPU_CYCLE_TIME", str(GROUP_CYCLE_MS))
    ref_hvd.init()
    try:
        timelines, allreduces, params = _run(
            ref_hvd, ref_metrics, narrow_resnet(seed=0), tmp, True)
    finally:
        hvt_mod.shutdown()
        mp.undo()
    ice = [[("NCCL_ALLREDUCE" if ph == "ICI_ALLREDUCE" else ph, n)
            for ph, n in tl] for tl in timelines]
    return {"timelines": ice, "allreduces": allreduces, "params": params,
            "trace": trace_span_names(str(tmp / "trace" /
                                          "rank0.trace.json"))}


def test_world_of_one_spans_counts_and_params_match_reference(
        reference_slice, tmp_path, monkeypatch):
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVTPU_TRACE", str(tmp_path / "trace"))
    hvd.init(device="cpu")
    try:
        timelines, allreduces, params = _run(
            hvd, port_metrics, narrow_resnet(seed=0), tmp_path, True)
    finally:
        hvd.shutdown()
    ref = reference_slice
    assert timelines == ref["timelines"]
    assert len(timelines) == STEPS
    fused = [n for ph, n in timelines[0] if ph == "NCCL_ALLREDUCE"]
    grads = [n for ph, n in timelines[0] if ph == "NEGOTIATE_ALLREDUCE"]
    assert fused == [f"fused.{sorted(grads)[0]}.{len(grads)}"]
    trace = trace_span_names(str(tmp_path / "trace" / "rank0.trace.json"))
    assert trace == ref["trace"] and len(trace) == STEPS
    assert set(trace[0]) == set(grads)
    assert allreduces == ref["allreduces"] == STEPS
    for p, q in zip(params, ref["params"]):
        assert torch.equal(p, q)

    # every plane off: the same parameters, bitwise
    from horovod_tpu_torch.obs import flight, stepprof, tracing

    monkeypatch.delenv("HVTPU_TRACE")
    monkeypatch.setenv("HVTPU_FLIGHT", "0")
    monkeypatch.setenv("HVTPU_ANOMALY", "0")
    monkeypatch.setattr(stepprof, "ACTIVE", False)
    hvd.init(device="cpu")
    try:
        assert not (tracing.ACTIVE or flight.ACTIVE)
        _, _, off = _run(hvd, port_metrics, narrow_resnet(seed=0),
                         tmp_path, False)
    finally:
        hvd.shutdown()
    for p, q in zip(params, off):
        assert torch.equal(p, q)


def test_two_rank_slice(reference_slice, tmp_path):
    codes, res = spawn_world(obs_worker, 2, tmp_path, STEPS, timeout=120)
    assert codes == [0, 0], res
    ref = reference_slice
    for rank, r in enumerate(res):
        assert r["planes_on"] == [True, True, True, True]
        assert r["planes_off"] == [False, False]
        assert r["params_on"] == r["params_off"]
        assert r["allreduces"] == ref["allreduces"]
        assert r["aggregate_ranks"] == [0, 1] and r["aggregate_ok"]
        assert {"job", "stall", "flight", "anomaly", "stepprof",
                "controller"} <= set(r["debug"])
        assert r["burst"] == [[2.0 * i + 1.0] * 3 for i in range(6)]
        spans = timeline_span_names(str(tmp_path / f"timeline{rank}.json"))
        assert [pair for pair in spans if "burst" not in pair[1]] == \
            sorted({pair for tl in ref["timelines"] for pair in tl})
        assert ("NCCL_ALLREDUCE", "fused.burst.0.6") in spans
        trace = tmp_path / "trace" / f"rank{rank}.trace.json"
        steps = trace_span_names(str(trace))
        assert steps[:STEPS] == ref["trace"]
        # the burst after the last step: every op through the chain
        with open(trace) as f:
            events = json.load(f)
        for i in range(6):
            name = f"burst.{i}"
            phases = [e["name"] for e in events
                      if e.get("ph") == "B"
                      and e["args"].get("tensor") == name]
            assert phases == ["NEGOTIATE", "QUEUE", "FUSE", "EXEC"]
            assert any(e["name"] == "DONE" and e["args"]["tensor"] == name
                       and e["args"]["fused"] == 6 for e in events)
        for key, d in r["diverged"].items():
            kind = key.split(":")[1]
            assert "diverged" in d["msg"], (key, d)
            assert f"{kind}.r0" in d["msg"] and f"{kind}.r1" in d["msg"]
            assert d["aborts"] >= 1, key
            assert f"{kind}.r{rank}" in d["postmortem"], key
        assert sorted(r["diverged"]) == sorted(
            f"{m}:{k}" for m in ("amortized", "strict") for k in OBS_KINDS)
    assert res[0]["params_on"] == res[1]["params_on"]
    # the clock handshake: rank 1 measured its offset to rank 0
    assert res[0]["offset_us"] == 0.0
    assert isinstance(res[1]["offset_us"], float)
    merged = hvtputrace.merge(str(tmp_path / "trace"))
    assert {e.get("pid") for e in merged if e.get("ph") == "B"} == {0, 1}


# -- F3-F6 ----------------------------------------------------------------

@pytest.fixture
def both_packages(tmp_path, monkeypatch):
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    ref_hvd.init()
    hvd.init(device="cpu")
    yield ref_hvd
    hvd.shutdown()
    hvt_mod.shutdown()


def test_f3_broadcast_object_takes_a_name(both_packages):
    ref_hvd = both_packages
    obj = {"a": 1, "w": torch.arange(3.0)}
    for call in (lambda h: h.broadcast_object(obj, 0, "state"),
                 lambda h: h.broadcast_object(obj, 0, name="state"),
                 lambda h: h.broadcast_object(obj, 0, "state", None)):
        got, want = call(hvd), call(ref_hvd)
        assert got["a"] == want["a"] == 1
        assert torch.equal(got["w"], want["w"])


def test_f3_broadcast_optimizer_state_matches_reference(both_packages):
    ref_hvd = both_packages
    out = []
    for h in (hvd, ref_hvd):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        h.broadcast_optimizer_state(opt, root_rank=0)
        out.append((opt.state_dict(), [p.detach().clone()
                                       for p in model.parameters()]))
    (sd, params), (ref_sd, ref_params) = out
    assert sd["param_groups"] == ref_sd["param_groups"]
    assert sd["state"].keys() == ref_sd["state"].keys()
    for k in sd["state"]:
        assert torch.equal(sd["state"][k]["momentum_buffer"],
                           ref_sd["state"][k]["momentum_buffer"])
    for p, q in zip(params, ref_params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("op", ["Min", "Max", "Product"])
def test_f5_optimizer_min_max_product_match_reference(both_packages, op):
    ref_hvd = both_packages
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4)).astype(np.float32))
    biases = []
    for h in (hvd, ref_hvd):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        opt = h.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), op=getattr(h, op))
        opt.zero_grad()
        model(x).sum().backward()
        opt.step()
        biases.append([p.detach().clone() for p in model.parameters()])
    for p, q in zip(*biases):
        assert torch.equal(p, q)
    assert biases[0][1].tolist() == pytest.approx([-0.3444, -0.1677],
                                                  abs=1e-4)


def test_f6_grouped_allreduce_takes_the_reference_order(both_packages):
    ref_hvd = both_packages
    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((3, 2), (5,))]
    ps = hvd.global_process_set
    got = hvd.grouped_allreduce(ts, None, None, hvd.Compression.none,
                                hvd.Sum, ps)
    want = ref_hvd.grouped_allreduce(ts, None, None,
                                     ref_hvd.Compression.none, ref_hvd.Sum,
                                     ref_hvd.global_process_set)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scaled = hvd.grouped_allreduce(copy.deepcopy(ts), op=hvd.Sum,
                                   prescale_factor=2.0,
                                   postscale_factor=0.5)
    for s, t in zip(scaled, ts):
        assert torch.equal(s, t)
    with pytest.raises(TypeError):
        hvd.grouped_allreduce(ts, None, None, hvd.Compression.none,
                              hvd.Sum, ps, 2.0)
