"""Build the port's C++ negotiation core (``native/src``) with g++.

The library lands in ``build/horovod_tpu_torch/`` beside the package,
as the CUDA kernels' libraries do (``ops/_build.py``), named by a hash
of every source, every header, the compiler and the flags: an edit
rebuilds, an unchanged tree reuses the last build.  Each ``.cc`` is
compiled by its own g++ process, all at once, then linked.

The flags are the JAX package's ``Makefile``'s (``-O2 -std=c++17 -fPIC
-pthread``) plus ``-fvisibility=hidden`` and a version script that
exports ``hvt_*`` alone, so that a second copy of the core in the same
process (the JAX package's ``libhvt_core.so``) and this one never bind
to each other's internals.

Concurrent first builds (the launcher's ranks, test workers) take a file
lock; each compiles to a private name and ``os.replace``s it into
place, so nobody loads a half-written library.  Nothing is built at
import time.  A failed build raises with the compiler's output: there is
no quiet fallback to the Python core.

``HVTPU_SKIP_NATIVE_BUILD`` (the reference's knob) never compiles: it
takes the library of the current sources if it is built, else the
newest one built before (``native/core.py`` checks its ABI), and raises
when there is none, where the reference quietly runs its Python core.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-fvisibility=hidden"]
EXPORTS = "{\n  global: hvt_*;\n  local: *;\n};\n"
FORCE_PY = "HVTPU_FORCE_PY_CONTROLLER"
SKIP_BUILD = "HVTPU_SKIP_NATIVE_BUILD"


def sources() -> List[Path]:
    return sorted(SRC.glob("*.cc"))


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def lib_path() -> Path:
    """The library's path, keyed on the sources, the headers, the
    compiler, the flags and the export list."""
    h = hashlib.sha256()
    for f in sorted(SRC.glob("*.cc")) + sorted(SRC.glob("*.h")):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join([compiler(), *CXXFLAGS, EXPORTS]).encode())
    return BUILD_DIR / f"libhvt_core-{h.hexdigest()[:16]}.so"


def _fail(what: str, log: str) -> RuntimeError:
    return RuntimeError(
        f"the native negotiation core failed to build ({what}):\n{log}\n"
        f"Set {FORCE_PY}=1 to run the Python core instead.")


def build() -> Path:
    """The library built from the current sources, compiling it first if
    it is missing; raises with the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    if os.environ.get(SKIP_BUILD):
        return _prebuilt()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libhvt_core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():       # another process may have built it
                _compile(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _prebuilt() -> Path:
    """The newest library already built, for ``HVTPU_SKIP_NATIVE_BUILD``."""
    built = sorted(BUILD_DIR.glob("libhvt_core-*.so"),
                   key=lambda p: p.stat().st_mtime)
    if not built:
        raise RuntimeError(
            f"{SKIP_BUILD} is set and no native negotiation core is built "
            f"under {BUILD_DIR}; unset it to build one, or set "
            f"{FORCE_PY}=1 to run the Python core instead.")
    return built[-1]


def _compile(out: Path) -> None:
    cxx = compiler()
    if shutil.which(cxx) is None:
        raise _fail(f"{cxx} not found", "set CXX or put g++ on PATH")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR,
                                     prefix=".hvt_core_") as tmp:
        tmp = Path(tmp)
        procs = []
        for src in sources():
            obj = tmp / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [cxx, *CXXFLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}: exit {proc.returncode}\n{log}")
        if failed:
            raise _fail(cxx, "\n".join(failed))
        exports = tmp / "exports.map"
        exports.write_text(EXPORTS)
        part = tmp / out.name
        link = subprocess.run(
            [cxx, *CXXFLAGS, "-shared",
             f"-Wl,--version-script={exports}", "-o", str(part),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise _fail(f"{cxx} link", link.stdout)
        os.replace(part, out)
