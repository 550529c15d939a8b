"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
source rebuilds and a stale library is never loaded. Nothing is built or
loaded when this module is imported: CPU-only hosts (no nvcc, no card)
import every module of the port.

Wrappers launch through ``launch``, which passes device pointers and the
stream as ``ctypes.c_void_p``; each C entry returns ``cudaGetLastError()``
after its launch, ``check`` raises if that is not 0, and ``count_launch``
counts the launch, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels "
                       "are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that have no current library,
    one nvcc process per source, all started together. Returns the seconds
    each build took (0.0 where the library was already current); raises
    RuntimeError with nvcc's output if a build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(f"kernel {name!r} needs a CUDA device; none is available")
            if not _lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry's ``cudaGetLastError()`` is not cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch (cudaError {err})")


def launch(name: str, fn, pointers, ints, device) -> None:
    """Call the C entry ``fn`` with device pointers, then ints, then the
    current stream of ``device`` (on that device); raise if the launch
    failed, else count it. The host work here is kept small: a served
    forward calls it once per kernel launch."""
    import torch

    if fn.argtypes is None:  # ctypes caches fn per library: typed once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                       + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*pointers, *ints, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*pointers, *ints, stream)
    check(err, name)
    count_launch(name)


def count_launch(name: str) -> None:
    with _lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()
