"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
source rebuilds and a stale library is never loaded. A source may be built
in several variants, each with its own ``-D`` defines and library (a
target: the source's name and its defines), each at its first use; the ops
name theirs (``ops.kernel_targets``). Nothing is built or loaded when this
module is imported: CPU-only hosts (no nvcc, no card) import every module of
the port.

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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple, Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_launches: Dict[str, int] = {}

# a library: a source name and the -D defines it is built with
Target = Tuple[str, Tuple[str, ...]]


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def label(target: Target) -> str:
    """``name`` or ``name[-DA=1 -DB=2]``: how builds and logs name a library."""
    name, defines = target
    return f"{name}[{' '.join(defines)}]" if defines else name


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


def _target(t: Union[str, Sequence]) -> Target:
    return (t, ()) if isinstance(t, str) else (t[0], tuple(t[1]))


def _lib_path(target: Target) -> Path:
    name, defines = target
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = "".join("." + d.removeprefix("-D").replace("=", "") for d in defines)
    return BUILD_DIR / f"{name}{tag}-{h.hexdigest()[:16]}.so"


def _log_path(target: Target) -> Path:
    """nvcc's output (its ``-Xptxas -v`` report) beside the library."""
    return _lib_path(target).with_suffix(".ptxas")


def build(which: Iterable[Union[str, Target]]) -> Dict[str, float]:
    """Compile the libraries named by ``which`` (source names or (name,
    defines) targets) that have no current library, one nvcc process each,
    all started together. Returns the seconds from the start to each build's
    end by ``label`` (0.0 where the library was already current); raises
    RuntimeError with nvcc's output if a build fails."""
    todo = [_target(t) for t in which]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for target in todo:
        out = _lib_path(target)
        if out.exists():
            took[label(target)] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *target[1], "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC_DIR / f"{target[0]}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        done = {}

        def wait(proc=proc, done=done):  # each build's own end, not the order it is read in
            done["log"] = proc.communicate()[0]
            done["s"] = time.perf_counter() - t0

        thread = threading.Thread(target=wait)
        thread.start()
        procs[label(target)] = (proc, thread, done, tmp, out)
    failed = []
    for name, (proc, thread, done, tmp, out) in procs.items():
        thread.join()
        took[name] = done["s"]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{done['log']}")
            continue
        _log_path(next(t for t in todo if label(t) == name)).write_text(done["log"])
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``, built
    first if needed."""
    target = (name, tuple(defines))
    with _lock:
        lib = _libs.get(target)
        if lib is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(f"kernel {label(target)!r} needs a CUDA device; none is "
                                   "available")
            if not _lib_path(target).exists():
                build([target])
            lib = ctypes.CDLL(str(_lib_path(target)))
            _libs[target] = lib
        return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)' for '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(log: str) -> list:
    """One record per kernel of an ``-Xptxas -v`` log: symbol, arch,
    registers, static shared memory, stack frame and spill bytes."""
    records, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"symbol": m.group(1), "arch": m.group(2)}
            records.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return records


def demangle(names) -> Dict[str, str]:
    """The C++ names of mangled symbols, where c++filt is installed (else
    the symbols themselves)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.split("\n")
        return dict(zip(names, out))
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}


def ptxas_report(target: Union[str, Sequence]) -> list:
    """``parse_ptxas`` of the current library ``target``'s build (the report
    ``build`` keeps beside it), each record with its C++ name as ``kernel``;
    empty where the library has not been built."""
    log = _log_path(_target(target))
    records = parse_ptxas(log.read_text() if log.exists() else "")
    names = demangle([r["symbol"] for r in records]) if records else {}
    for r in records:
        r["kernel"] = names[r["symbol"]]
    return records


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
