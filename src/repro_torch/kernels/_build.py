"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source has a plain C entry point and is compiled on its own with
``nvcc`` into a shared library at first use, then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<stem>_<hash>.so <source>

The library goes to ``build/kernels/`` at the root of the checkout, named by
the source's stem and a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and an unchanged one is built once per checkout. A failed
build raises. Two sources build in parallel (one lock per source), so a
caller that needs several kernels starts all builds at once. Nothing here
runs when the module is imported: the CPU tests import it on hosts without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Build:
    library: Path
    command: tuple[str, ...]
    log: str                      # nvcc's output, with the -Xptxas -v lines


_guard = threading.Lock()
_locks: dict[Path, threading.Lock] = {}
_builds: dict[Path, Build] = {}
_libs: dict[Path, ctypes.CDLL] = {}


def _lock(source: Path) -> threading.Lock:
    with _guard:
        return _locks.setdefault(source, threading.Lock())


def nvcc() -> str:
    """The path of ``nvcc``: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built (put nvcc on PATH or set CUDA_HOME)")


def build(source: Path) -> Build:
    """Compile ``source`` unless this source and these flags were already
    built in this checkout. Returns the library, the command and nvcc's
    log."""
    with _lock(source):
        if source in _builds:
            return _builds[source]
        headers = b"".join(h.read_bytes()
                           for h in sorted(source.parent.glob("*.cuh")))
        digest = hashlib.sha256(
            source.read_bytes() + headers
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{source.stem}_{digest}.so"
        log_path = lib.with_suffix(".log")
        compiler = nvcc()

        def command(out: Path) -> tuple[str, ...]:
            return (compiler, *NVCC_FLAGS, "-o", str(out), str(source))
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # nvcc names the output's kind by its suffix: keep ".so"
            tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
            proc = subprocess.run(command(tmp), capture_output=True,
                                  text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(command(tmp))}\n{log}")
            log_path.write_text(log)
            tmp.replace(lib)
        log = log_path.read_text() if log_path.exists() else ""
        _builds[source] = Build(library=lib, command=command(lib), log=log)
        return _builds[source]


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from ``source``, loaded once per process.
    ``bind`` declares its functions' ``argtypes``/``restype`` and may check
    the library's constants; it runs once, before the library is handed
    out."""
    info = build(source)
    with _lock(source):
        if source not in _libs:
            lib = ctypes.CDLL(str(info.library))
            bind(lib)
            _libs[source] = lib
        return _libs[source]
