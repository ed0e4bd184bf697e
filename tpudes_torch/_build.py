"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and builds into
``build/lib<name>-<digest>.so`` for ``sm_90a``, at first use, with its
parts ``csrc/<name>_*.cu`` (translation units that instantiate a share
of its kernels): every source of every library compiles to an object in
its own nvcc process, all started together, then each library links.
The digest covers the sources, every header in ``csrc/`` and the flags,
so an edited source or header never loads a stale library.  There is
no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: one source to an object (ptxas reports each kernel's registers, shared
#: memory and spills)
COMPILE_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: one source straight to a library
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and its parts ``csrc/<name>_*.cu``."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob(f"{name}_*.cu"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in (*sources(name), *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc per source of a library; returns ``(jobs, out)``,
    ``jobs`` a list of ``(source, proc, object)``, or None when the
    library is already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources(name):
        obj = BUILD / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), obj))
    return jobs, out


def build(names) -> dict[str, str]:
    """Compile every source of every named library, all nvcc processes
    started together, then link each library; returns each library's
    compiler output (empty when it was cached).  Raises if any build
    fails."""
    started = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        jobs, out = job
        texts, objs, ok = [], [], True
        for src, proc, obj in jobs:
            text, _ = proc.communicate()
            texts.append(text)
            objs.append(obj)
            if proc.returncode != 0:
                failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n"
                              f"{text}")
                ok = False
        if ok:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc(), *ARCH, "-shared", "-o", str(tmp),
                 *[str(o) for o in objs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            texts.append(link.stdout)
            if link.returncode != 0:
                failed.append(f"{name} (link exit {link.returncode}):\n"
                              f"{link.stdout}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        for obj in objs:
            obj.unlink(missing_ok=True)
        logs[name] = "".join(texts)
        (BUILD / f"{name}.log").write_text(logs[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
