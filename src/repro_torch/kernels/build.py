"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries are keyed by a hash of the
source, the ``csrc/`` headers it includes and the flags, and written to
``build/kernels/`` at the repository root (listed in ``.gitignore``;
``REPRO_TORCH_BUILD_DIR`` overrides it).  Nothing
is built at import time: a kernel is built on its first launch, or by
:func:`build` ahead of time, which starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = {
    "photonic_mvm_fused": "photonic_mvm_fused.cu",
    "photonic_mvm_split": "photonic_mvm_split.cu",
    "photonic_mvm_resident": "photonic_mvm_resident.cu",
    "blend_shuffle": "blend_shuffle.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_chunk": "ssd_chunk.cu",
    "decode_attention": "decode_attention.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise FileNotFoundError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels need "
        "the CUDA toolkit (the CPU path needs none)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """The ``.cu`` file of kernel ``name`` and every ``csrc/`` header it
    includes, directly or through another header (``#include "..."``)."""
    todo, seen = [csrc_dir() / SOURCES[name]], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def library_path(name: str) -> Path:
    """Library of kernel ``name``, keyed by its source, the headers it
    includes and the flags: editing a shared header rebuilds every kernel
    that includes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns per-name build
    seconds (0.0 for a library already built) and raises with the compiler
    output if any build fails.  The ``-Xptxas=-v`` report (registers,
    shared memory, spills) lands beside each library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        nvcc = find_nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(csrc_dir() / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, lib)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, errstr: str, code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if code != 0:
        fn = getattr(lib, errstr)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code}: "
                           f"{fn(code).decode(errors='replace')}")
