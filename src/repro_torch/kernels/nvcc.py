"""Build and load the port's CUDA kernels.

Each kernel source (``csrc/*.cu`` beside its wrapper) is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, under ``build/repro_torch/`` at the root of the
checkout (listed in .gitignore), and loaded with ``ctypes``.  A library
is built once per source content and flag set.  Nothing here runs when
a module is imported: the CPU tests import every module and have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

#: build output, at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: ``-split-compile=0`` runs the optimizer and ptxas on the kernel
#: variants of one source in parallel, one thread per core
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their csrc/*.cu sources with the CUDA toolkit "
                       "(set CUDA_HOME)")


class CudaLibrary:
    """One CUDA source and the C functions it exports.

    ``signatures`` maps each exported function to its ctypes argument
    types; every function returns the launch's ``cudaError_t`` as an
    int.  :meth:`build` compiles (thread-safe; several libraries may
    build at once, one ``nvcc`` each) and :meth:`lib` loads."""

    def __init__(self, src: Path, signatures: dict[str, list]):
        self.src = Path(src)
        self.signatures = signatures
        #: the compiler's report (registers, shared memory, spills) of
        #: the build this process ran; empty if the library was cached
        self.log = ""
        self._lib = None
        self._lock = threading.RLock()

    def build(self) -> Path:
        """Compile the source into a shared library (once per source
        content and flag set) and return its path."""
        with self._lock:
            src = self.src.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:12]
            out = BUILD_DIR / f"lib{self.src.stem}-{tag}.so"
            if out.exists():
                return out
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(self.src)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.src.name} with "
                                   f"code {proc.returncode}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            self.log = proc.stdout + proc.stderr
            os.replace(tmp, out)
            return out

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib
