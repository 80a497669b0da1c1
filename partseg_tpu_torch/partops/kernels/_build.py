"""Build and load the CUDA kernels of ``partseg_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together), linked into one shared library with
a plain C interface, and loaded with ``ctypes``. The build happens at
first use and is cached by a hash of the sources and flags under
``build/kernels/`` beside the package (listed in ``.gitignore``), so a
fresh checkout builds its own kernels in a few seconds.

Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _tag(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], lib_path: Path) -> None:
    nvcc = nvcc_path()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        (lib_path.parent / "build.log").write_text("".join(logs))
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libpartseg_kernels-{_tag(sources)}.so"
    if not lib_path.exists():
        _build(sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.partseg_error_string.argtypes = [ctypes.c_int]
    lib.partseg_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        text = library().partseg_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({text})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream
