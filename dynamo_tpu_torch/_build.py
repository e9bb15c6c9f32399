"""Build the port's CUDA kernels and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into ``build/dynamo_tpu_torch/lib<name>-<digest>.so`` beside the package
(``build/`` is git-ignored), loaded with ``ctypes``. The digest covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and a built one is
reused. Nothing here runs at import time: a kernel's wrapper calls
``load`` when it first launches on a CUDA tensor, and ``build`` compiles
all sources at once, one ``nvcc`` process each, started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "dynamo_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels needs the CUDA toolkit")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # what the sources include
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (all of ``csrc/`` by default) that are not
    built yet, one ``nvcc`` each, all started together. Returns, per name,
    the library path, the build seconds (0 when reused) and nvcc's
    output (ptxas register and spill report). Raises on a failed build."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, dict] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())

    def finish(name):  # one thread per process, so each build's seconds are its own
        proc, _, _, t0 = running[name]
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(running))) as pool:
        finished = dict(zip(running, pool.map(finish, running)))
    failed = []
    for name, (proc, tmp, out, _) in running.items():
        log, seconds = finished[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        results[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
