"""Build and load the CUDA kernels of ``partseg_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together), linked into one shared library with
a plain C interface, and loaded with ``ctypes``. The build happens at
first use and is cached by a hash of the sources, headers and flags under
``build/kernels/`` beside the package (listed in ``.gitignore``), so a
fresh checkout builds its own kernels in a few seconds. Each C entry
point's ``ctypes`` signature is bound once, when the library is loaded
(``SIGNATURES``), and ``launch`` calls it on PyTorch's current stream.

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
# -split-compile=0: each source's device code is optimized on all the
# host's cores; render_assemble.cu, the longest source, builds in about
# half the time (39 s against 83 s on the H100's host).
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Every C entry point: its argument types (pointers and the stream as
# c_void_p, ints as c_int, long longs as c_longlong, floats as c_float; see
# the comment above each in csrc/) and its return type. ctypes would pass an
# unannotated Python int as a 32-bit int and cut a pointer.
SIGNATURES = {
    "partseg_error_string": ([_I], ctypes.c_char_p),
    "partseg_softmax_moments_f32": ([_P] * 3 + [_I] * 5 + [_P], _I),
    "partseg_render_assemble": ([_P] * 3 + [_I, _P] + [_I] * 6 + [_P], _I),
    "partseg_render_assemble_tiled": ([_P] * 3 + [_I, _P] + [_I] * 8 + [_P], _I),
    "partseg_render_assemble_bwd": ([_P] * 4 + [_I] + [_P] * 4 + [_I] * 7 + [_P], _I),
    "partseg_tps_warp": ([_P, _I, _P, _P, _P] + [_I] * 7 + [_P], _I),
    "partseg_tps_warp_plan": ([_I] * 6 + [_P], None),
    "partseg_bilinear_sample": ([_P, _I, _P, _P, _P, _P] + [_I] * 6 + [_P], _I),
    "partseg_group_norm_fwd": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    "partseg_group_norm_bwd": ([_P] * 9 + [_I] * 10 + [_P], _I),
    "partseg_bias_act_fwd": ([_P] * 5 + [_I] * 3 + [_L] + [_I] * 3 + [_P], _I),
    "partseg_bias_act_bwd": ([_P] * 6 + [_I] * 3 + [_L] + [_I] * 3 + [_P], _I),
}


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


def _tag(csrc: Path, sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources + sorted(csrc.glob("*.cuh")):
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
def library(csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library;
    ``csrc`` names another checkout's sources (a baseline to time against)."""
    sources = sorted(csrc.glob("*.cu"))
    lib_path = BUILD_DIR / f"libpartseg_kernels-{_tag(csrc, sources)}.so"
    if not lib_path.exists():
        _build(sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in SIGNATURES.items():
        if hasattr(lib, name):          # a baseline may lack newer entry points
            fn = getattr(lib, name)     # CDLL caches it: the binding sticks
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        text = library().partseg_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({text})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized int
    (read without making a ``torch.cuda.Stream`` object)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def launch(entry: str, device: torch.device, *args, lib: ctypes.CDLL | None = None,
           stream: int | None = None) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``device`` (or ``stream``, that handle) appended; raise if it returns
    a CUDA error. The device is made current only when it is not already."""
    fn = getattr(lib or library(), entry)
    handle = stream_handle(device) if stream is None else stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, handle)
    else:
        with torch.cuda.device(device):
            err = fn(*args, handle)
    check_launch(err, entry.removeprefix("partseg_"))
