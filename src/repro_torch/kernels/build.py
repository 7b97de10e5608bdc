"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library with a
plain C interface under ``build/kernels/`` at the root of the checkout.  The
library's file name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing builds at import:
the first call that needs a kernel builds it, so the CPU tests can import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; one load per process
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> dict[str, str]:
    """Compile every named source not yet built, all ``nvcc`` runs started
    together; returns each source's compiler log (``-Xptxas -v`` lists
    registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            logs[name] = f"{out.name}: up to date"
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return _LOADED[name]


def sass_counts(name: str, ops: Sequence[str] = ("HGMMA", "HMMA")) -> dict[str, dict[str, int]]:
    """Tensor-core instructions in the built library of ``csrc/<name>.cu``,
    per kernel function, from ``cuobjdump -sass``: {mangled name: {op:
    count}}.  Proof that a body runs on the tensor cores."""
    tool = Path(nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_target(name))], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            out[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    out[fn][op] += 1
    return out


def launched(counts: dict, name: str, err: int) -> None:
    """After a call of a C entry point: raise if it refused the launch (its
    return value is ``cudaGetLastError()``), else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    counts[name] += 1
