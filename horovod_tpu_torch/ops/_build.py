"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``; pointers and
the stream travel as ``c_void_p``.  No PyTorch headers are included, so a
build takes seconds.

Libraries land in ``build/horovod_tpu_torch/`` beside the package, named
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edit rebuilds and an unchanged
tree reuses the last build.  ``build_all()`` starts one ``nvcc`` per
source, all at once, and waits for them together; ``build_copies()``
compiles patched copies of one source the same way, for the sweep
scripts.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib_path(source: Path) -> Path:
    """Output path of ``source``, keyed on its text, the text of every
    header beside it (a ``.cu`` may include any of them) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from source at first use")


def nvcc_command(source: Path, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel;
    returns {stem: library path}.  Raises with nvcc's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {s.stem: lib_path(s) for s in sources()}
    procs = []
    for src in sources():
        out = outs[src.stem]
        if out.exists():
            continue
        # write to a private name, then rename: concurrent processes
        # (one per rank) never load a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outs


def build_copies(stem: str, variants: Dict[str, Dict[str, str]],
                 out_dir: Path, extra_flags: Sequence[str] = ()
                 ) -> Dict[str, Tuple[Path, str]]:
    """Compile copies of ``csrc/<stem>.cu`` with parts of its text
    replaced, all at once; for the sweep scripts, which time a kernel at
    other constants than the shipped ones.

    ``variants`` maps a name to ``{text: replacement}``; each text must
    occur exactly once in the source.  Copy ``name`` lands, with the
    headers beside it, in ``out_dir/name/``.  Returns ``{name: (library
    path, nvcc's output)}``; raises with nvcc's output on failure."""
    text = (CSRC / f"{stem}.cu").read_text()
    procs = {}
    for name, patches in variants.items():
        copy = text
        for old, new in patches.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{stem}.cu does not hold '{old}' "
                                   "exactly once")
            copy = copy.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            (d / header.name).write_bytes(header.read_bytes())
        src = d / f"{stem}.cu"
        src.write_text(copy)
        out = d / f"lib{stem}.so"
        procs[name] = (out, subprocess.Popen(
            nvcc_command(src, out) + list(extra_flags),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu as {name}: nvcc exit "
                          f"{proc.returncode}\n{log}")
        built[name] = (out, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it first if
    needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _libs[stem] = lib
        return lib
