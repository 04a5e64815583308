"""Kernel A1 of the PyTorch port, ``fused_scale_cast``, on the CPU.

The CUDA kernel (``horovod_tpu_torch/csrc/scale_cast.cu``) runs only on
the card, where ``chip_smoke.py`` holds it bitwise against the plain
version.  Here the plain version, which the wrapper takes for a CPU
tensor, is held bitwise against the JAX package's ``fused_scale_cast``
run through its Pallas body in interpret mode (as
``tests/test_pallas_ops.py`` runs it), for float32/bfloat16/float16 in
and out.  Results are compared as unsigned-integer views.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_scale_cast as jax_fused_scale_cast
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import fused_scale_cast, fused_scale_cast_plain
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

DTYPES = {
    "f32": (torch.float32, jnp.float32, np.uint32, torch.int32),
    "bf16": (torch.bfloat16, jnp.bfloat16, np.uint16, torch.int16),
    "f16": (torch.float16, jnp.float16, np.uint16, torch.int16),
}


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _inputs(n: int, seed: int = 0) -> np.ndarray:
    """float32 values spread over 12 decades, so the narrow outputs see
    overflow to inf, subnormals and ties."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-8, 4, size=n)
    return (rng.randn(n) * mag).astype(np.float32)


def _bits_torch(t: torch.Tensor, key: str) -> np.ndarray:
    _, _, np_u, t_i = DTYPES[key]
    return t.view(t_i).numpy().view(np_u)


def _bits_jax(a, key: str) -> np.ndarray:
    _, _, np_u, _ = DTYPES[key]
    return np.asarray(a).view(np_u)


@pytest.mark.parametrize("n", [1, 1000, 1024, 3000])
@pytest.mark.parametrize("in_key", list(DTYPES))
@pytest.mark.parametrize("out_key", list(DTYPES))
def test_plain_matches_pallas_bitwise(interpret_mode, n, in_key, out_key):
    t_in, j_in = DTYPES[in_key][:2]
    t_out, j_out = DTYPES[out_key][:2]
    x32 = _inputs(n, seed=n)
    x_t = torch.from_numpy(x32).to(t_in)
    x_j = jnp.asarray(x32).astype(j_in)
    # the narrowing of the inputs rounds alike on both sides
    np.testing.assert_array_equal(_bits_torch(x_t, in_key),
                                  _bits_jax(x_j, in_key))
    for scale in (0.5, 2.0, 1.0 / 3.0):
        got = fused_scale_cast_plain(x_t, scale, t_out)
        want = jax_fused_scale_cast(x_j, scale, j_out)
        assert got.dtype == t_out and tuple(got.shape) == (n,)
        np.testing.assert_array_equal(_bits_torch(got, out_key),
                                      _bits_jax(want, out_key),
                                      err_msg=f"scale={scale}")


def test_wrapper_takes_plain_version_for_cpu_tensor():
    x = torch.from_numpy(_inputs(4097))
    before = fused_scale_cast.launches
    got = fused_scale_cast(x, 0.25, torch.bfloat16)
    want = fused_scale_cast_plain(x, 0.25, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert fused_scale_cast.launches == before  # no kernel launched
    assert fused_scale_cast(x, 3.0).dtype == torch.float32


def test_scale_rounds_to_float32():
    # the kernel takes the scale as a C float: the plain version must
    # round it the same way before the multiply
    x = torch.tensor([1.0, 3.0, 7.0], dtype=torch.float32)
    s = 0.1
    want = x * torch.tensor(s, dtype=torch.float32)
    assert torch.equal(fused_scale_cast_plain(x, s), want)


def test_build_is_keyed_on_sources_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    first = _build.lib_path(src)
    assert first.parent == tmp_path / "out"
    assert first.name.startswith("libk-") and first.suffix == ".so"
    src.write_text("// b\n")
    assert _build.lib_path(src) != first
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert "fast_math" not in flags  # denormals must not flush


def test_every_kernel_source_is_built():
    stems = {p.stem for p in _build.sources()}
    assert {"scale_cast", "quantize_int8"} <= stems
