"""Every configuration, traffic mix, limit file and per-layer metric that
``BENCHMARK.json`` names is found by its name."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import cell, reference, run
from portbench.counters import conv_flops

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_spec_loads(name):
    spec = run.make_spec(name, 2 ** 31 + 5, 1, 0)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert spec["traffic"]["ranks"] == entry["chips"]
    assert spec["config"]["name"] == entry["config"]
    assert spec["traffic"]["distinct_batches"] >= spec["traffic"][
        "check_steps"]
    limits = spec["limits"]
    assert "logits_gap" in limits and "loss_gap" in limits
    assert ("ranks_differing" in limits) == (entry["chips"] > 1)
    for name, lim in limits.items():
        # each limit lies above the program's largest reading and below
        # the least reading of the control or a fault that it must fail
        assert lim["lower"] <= lim["limit"] < lim["upper"], name
        assert lim["seeds"] >= 12
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "images_per_s"} <= names
    assert spec["per_layer"]


# a width, which no cut may name: a hidden, intermediate, latent, state
# or projection size, a key ending in _dim or _rank, a head size, an
# expansion factor, the experts a token picks
WIDTH = re.compile(r"(_dim|_rank)$|^hidden_size$|intermediate|latent|state"
                   r"|proj|head_size|expan|expand|per_tok|^d_model$|^n_embd$"
                   r"|^num_filters$")


@pytest.mark.parametrize("key,width", [
    ("hidden_size", True), ("moe_intermediate_size", True),
    ("kv_lora_rank", True), ("qk_rope_head_dim", True), ("d_state", True),
    ("num_experts_per_tok", True), ("expand", True), ("num_filters", True),
    ("num_hidden_layers", False), ("n_routed_experts", False),
    ("vocab_size", False), ("first_k_dense_replace", False),
])
def test_width_keys_are_told_apart(key, width):
    assert bool(WIDTH.search(key)) == width


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    # a cell runs the port's own models, never a stand-in
    assert "port_module" not in data
    # a chip's share (a model_config's experts, vocabulary, depth) is
    # named in both, each key cut is one the file holds and none is a
    # width; an image network runs whole
    assert data["reduced"] == config["reduced"]
    assert set(data["reduced"]) <= set(data)
    assert not [k for k in data["reduced"] if WIDTH.search(k)]
    if data.get("task", "image_classification") == "image_classification":
        assert data["reduced"] == []
    model = reference.build(data, "meta")
    assert sum(p.numel() for p in model.parameters()) == data["parameters"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    read = cell.load_reader(metric["name"])
    assert callable(read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_units_keep_to_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


def test_published_forward_macs():
    """ResNet-50 v1.5 about 4.1 GMACs and VGG-16 about 15.5 GMACs an
    image at 224, forward (the papers' and torchvision's totals)."""
    r = json.loads((ROOT / "portbench/configs/resnet50-v1.5.json")
                   .read_text())
    v = json.loads((ROOT / "portbench/configs/vgg16.json").read_text())
    assert conv_flops.forward_macs(r) == pytest.approx(4.089e9, rel=1e-3)
    assert conv_flops.forward_macs(v) == pytest.approx(15.470e9, rel=1e-3)
    # a step: forward, weight gradient and input gradient (the first
    # layer has none) at two flops a multiply-add
    first = conv_flops.layers(r)[0].macs
    want = 2 * (3 * conv_flops.forward_macs(r) - first) * 256
    assert conv_flops.step_work(r, 256)["flops"] == pytest.approx(want)


def test_cell_refuses_a_stand_in_model(tmp_path):
    """A cell whose configuration names ``port_module`` is refused before
    it runs: a cell times and checks the port's own models."""
    entry = BENCH["workloads"][0]
    for sub in ("configs", "traffic"):
        (tmp_path / "portbench" / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    config = json.loads((ROOT / "portbench" / "configs"
                         / f"{entry['config']}.json").read_text())
    config["port_module"] = "portbench.tests.tiny_lm"
    (tmp_path / "portbench" / "configs" / f"{entry['config']}.json"
     ).write_text(json.dumps(config))
    traffic = ROOT / "portbench" / "traffic" / f"{entry['traffic']}.json"
    (tmp_path / "portbench" / "traffic" / traffic.name).write_text(
        traffic.read_text())
    with pytest.raises(run.RunError, match="port_module"):
        run.make_spec(entry["name"], 1, 1, 0, root=tmp_path)
    del config["port_module"]
    (tmp_path / "portbench" / "configs" / f"{entry['config']}.json"
     ).write_text(json.dumps(config))
    assert run.make_spec(entry["name"], 1, 1, 0, root=tmp_path)["config"] \
        == config
