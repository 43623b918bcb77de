"""Build and load the hand-written CUDA kernels of `repro_torch/csrc/`.

Each `csrc/<name>.cu` has a plain `extern "C"` launcher. At first use
`nvcc` compiles it for `sm_90a` into a shared library under
`<checkout>/build/` (or `$REPRO_TORCH_BUILD_DIR`), named by a hash of
the source, the `csrc/` headers it includes and the flags, and `ctypes`
loads it; later calls and later processes reuse the library while
those are unchanged.
`build_all` starts one `nvcc` per source, all at once, and waits for
them together.

`COUNTS` holds the launches per kernel name; each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
#: the sources of `csrc/`, each built into its own library: the
#: kernels and `host_memory`, the pinned-memory shim they share
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "page_copy", "adamw", "host_memory")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel name, counted where the kernel is launched
COUNTS: collections.Counter = collections.Counter()


def build_dir() -> pathlib.Path:
    """Where built kernels go: `$REPRO_TORCH_BUILD_DIR`, else `build/`
    at the root of the checkout (listed in .gitignore)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME; the CUDA "
            "kernels are built from source at first use")
    return path


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def headers(name: str) -> Tuple[pathlib.Path, ...]:
    """The headers of `csrc/` that `csrc/<name>.cu` includes (`#include
    "..."`), directly or through one another, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_text()):
            path = CSRC / inc
            if path not in found:
                found.append(path)
                todo.append(path)
    return tuple(found)


def library_path(name: str) -> pathlib.Path:
    """The library `build` makes for `csrc/<name>.cu` and its headers as
    they are now."""
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *headers(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES, force: bool = False
              ) -> Dict[str, Tuple[pathlib.Path, str]]:
    """Compile the libraries that are missing (or all, with `force`),
    one `nvcc` per source, all started together.

    Returns {name: (library path, compiler output — ptxas' register,
    shared memory and spill report — or "" when it was already
    built)}. Raises if any compile fails."""
    out: Dict[str, Tuple[pathlib.Path, str]] = {}
    running = []
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists() and not force:
                out[name] = (lib, "")
                continue
            lib.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, lib, tmp, proc))
        failed = []
        for name, lib, tmp, proc in running:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                              f"{report}")
                continue
            os.replace(tmp, lib)
            out[name] = (lib, report)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build(name: str, force: bool = False) -> Tuple[pathlib.Path, str]:
    """`build_all` of one source."""
    return build_all((name,), force)[name]


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    return ctypes.CDLL(str(build(name)[0]))
