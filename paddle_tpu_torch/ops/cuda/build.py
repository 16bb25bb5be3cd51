"""Build of the port's CUDA kernels: nvcc into one shared library with a
plain C interface, loaded with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own nvcc process,
all started together, then linked with ``nvcc -shared``. The library
lands in ``_build/<hash of sources and flags>/``, so a fresh checkout
builds it at first use and an unchanged tree reuses it. A missing nvcc
or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "find_nvcc", "last_build", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libpaddle_tpu_torch_cuda.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
# what the build of this process did: {"path", "seconds", "built", "ptxas"}
last_build = {}


def find_nvcc():
    """nvcc from ``$CUDA_HOME/bin``, else from ``PATH``, else from the
    toolkit's default prefix; raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of paddle_tpu_torch are "
        "compiled with nvcc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    """Hash of the flags and every source and header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands in parallel; return their stderr, raise on any
    failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}{err}")
    return [err for _out, err in outs]


def build():
    """Compile and link the library unless this tree's build exists.
    Returns its path."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        last_build.update(path=str(lib_path), seconds=0.0, built=False,
                          ptxas=(out_dir / "ptxas.txt").read_text()
                          if (out_dir / "ptxas.txt").is_file() else "")
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        logs = _run([[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", str(src), "-o",
                      str(obj)] for src, obj in zip(sources, objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        _run([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
               str(tmp_lib)]])
        ptxas = "".join(logs)
        (out_dir / "ptxas.txt").write_text(ptxas)
        # atomic: a concurrent build of the same tree sees all or nothing
        os.replace(tmp_lib, lib_path)
    last_build.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      built=True, ptxas=ptxas)
    return lib_path


def load_library():
    """The loaded library (built first if needed), one per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
