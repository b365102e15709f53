"""Build the package's CUDA sources at first use.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (sm_90a), one compiler
process per source, all started together, and link into one shared library
with a plain C interface, which ``load()`` opens with ctypes. The
library lands in ``mpas_ocean_tpu_torch/_build/`` under a name keyed by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. A missing ``nvcc`` or a failed build raises with
the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the CUDA kernels cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmot_kernels_{h.hexdigest()[:16]}.so"


def _compile(cmd: list) -> tuple:
    """Run one compiler command: (the finished process, its output, its
    wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, proc.stdout, time.perf_counter() - t0


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    The compilers' output (register and shared-memory use per kernel) is
    kept beside the library as ``.log``, with one line per source of its
    compile's wall seconds ("nvcc <source>: <s> s")."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(sources, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(_compile, cmds))
    procs, logs = [r[0] for r in runs], [r[1] for r in runs]
    logs.append("".join(f"nvcc {s.name}: {r[2]:.2f} s\n" for s, r in zip(sources, runs)))
    tmp = out.with_name(f"{tag}.tmp.so")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
            str(tmp), *map(str, objs)]
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library for the sources as they are at the first call,
    built if needed. Later calls reuse it without hashing the sources
    again: that hash, taken on every launch, cost ~0.8 ms per call."""
    return ctypes.CDLL(str(build()))
