"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface. ``nvcc``
compiles it for ``sm_90a`` into a shared library, cached in ``build/kernels/``
(gitignored) under a name that carries a hash of the source and the flags,
and ``ctypes`` loads it. Libraries are built at first use, inside the call
that launches a kernel, so importing a module never needs ``nvcc``.
``build_many`` starts one ``nvcc`` per source at once, so several kernels
build in the time of the slowest. A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232_448  # per-block dynamic shared memory on sm_90

# C signature of one exported function: (argtypes, restype)
Signature = Tuple[Sequence, object]

_LIBS: Dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the port's CUDA "
                           "kernels cannot be built")
    return path


def library_path(source: Path, build_dir: Optional[Path] = None) -> Path:
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    tag = hashlib.sha256(Path(source).read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return out_dir / f"lib{Path(source).stem}_{tag}.so"


def build_many(sources: Sequence[Path],
               build_dir: Optional[Path] = None) -> List[Tuple[Path, str]]:
    """Compile every source whose library is missing, all at once. Returns
    (library path, compiler output) per source — the ``ptxas -v`` register
    and shared-memory report, empty where the library was already built.
    Raises RuntimeError carrying nvcc's output if any compile fails."""
    libs = [library_path(s, build_dir) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    reports = {lib: "" for lib in libs}
    if todo:
        nvcc = find_nvcc()
        procs = []
        for src, lib in todo:
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.parent / f".{lib.name}.{os.getpid()}.tmp"
            procs.append((src, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {Path(src).name} with exit code "
                              f"{proc.returncode}:\n{out}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial .so
            reports[lib] = out
        if failed:
            raise RuntimeError("\n".join(failed))
    return [(lib, reports[lib]) for lib in libs]


def build(source: Path, build_dir: Optional[Path] = None) -> Tuple[Path, str]:
    """``build_many`` for one source."""
    return build_many([source], build_dir)[0]


def load(source: Path, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """Build ``source`` if needed, load it once per process and declare the
    exported functions' C signatures."""
    source = Path(source)
    lib = _LIBS.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _LIBS[source] = lib
    return lib


def check_launch(error_string, name: str, err: int) -> None:
    """Raise with the CUDA runtime's message (``error_string``, the library's
    C function) when a launch returned an error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({error_string(err).decode()})")
