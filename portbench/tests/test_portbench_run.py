"""The run's path at a tiny size on the CPU, in a fresh process each:
a sound run is correct and loads no JAX module; each fault the cell can
have, planted under the timed path, comes out not correct.  ``tiny_lm``
is the tests' causal language model (``tiny.py``): token batches, the
per-token loss, AdamW."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cell, trace=0, fault=None, tmp_path=None, ranks=1):
    cmd = [sys.executable, "-m", "portbench.tests.tiny", cell, str(trace),
           fault or "", str(ranks)]
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), proc.stderr


@pytest.mark.parametrize("cell,ranks", [("resnet50.b256.fp16", 1),
                                        ("vgg16.b64.fp16", 1),
                                        ("vgg16.b64.fp16", 2),
                                        ("tiny_lm", 1), ("tiny_lm", 2)])
def test_sound_run_is_correct(cell, ranks, tmp_path):
    line, err = _run(cell, tmp_path=tmp_path, ranks=ranks)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"images_per_s", "step_ms_p90",
                                    "peak_memory_gib", "setup_s"}
    # the limits are the last lines on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("cell", ["vgg16.b64.fp16", "tiny_lm"])
def test_traced_run_gives_breakdown(cell, tmp_path):
    line, _ = _run(cell, trace=1, tmp_path=tmp_path)
    assert line["correct"]
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU trace has no device operations: the readers read nothing
    assert line["metrics"] == {}
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault,ranks", [
    ("resnet50.b256.fp16", "no_update", 1),
    ("resnet50.b256.fp16", "half_batch", 1),
    ("vgg16.b64.fp16", "no_update", 1),
    ("vgg16.b64.fp16", "half_batch", 1),
    ("vgg16.b64.fp16", "no_exchange", 2),
    ("tiny_lm", "no_update", 1),
    ("tiny_lm", "half_batch", 1),
    ("tiny_lm", "no_exchange", 2),
])
def test_fault_is_not_correct(cell, fault, ranks, tmp_path):
    """Each fault a cell can have; the exchange between ranks only past
    one rank, the path that a cell on several chips takes."""
    line, _ = _run(cell, fault=fault, tmp_path=tmp_path, ranks=ranks)
    assert not line["correct"], line["checks"]


def test_run_refuses_without_a_card(tmp_path):
    """Here, with no CUDA: exit 2 and no result line."""
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "vgg16.b64.fp16", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
