"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object
file (one ``nvcc`` process per source, all started together), and the
objects link into one shared library with a plain C interface that
``ctypes`` loads.  Each C entry point takes device pointers, sizes, the
device index and the CUDA stream, launches its kernel and returns
``cudaGetLastError()``; :func:`launch` raises on anything but 0.

The library builds at first use into ``build/repro_torch/`` at the root of
the checkout, under a name that hashes the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.  A missing ``nvcc`` or a
failed build raises: the kernels have no silent substitute on the card.

``LAUNCHES`` counts, per kernel, the launches the wrappers in ``ops.py``
made since the last :func:`reset_launches`: each wrapper adds one where it
launches its kernel, and nowhere else.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers, ints, then device and stream).
SIGNATURES = {
    "sim_search_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P),
    "sim_gather_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "sim_lookup_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _P),
    "sim_plan_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _P),
    "sim_fused_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _I, _I, _I, _P),
}

LAUNCHES = {"sim_search": 0, "sim_gather": 0, "sim_lookup": 0,
            "sim_plan": 0, "sim_fused": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels in "
                           f"{CSRC} cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsim_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(staged, lib)     # atomic: concurrent builders never race
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(entry: str, *args, device: torch.device) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream; raise if
    the launch is refused.  Tensor arguments pass as their data pointers,
    ``None`` as a null pointer."""
    stream = torch.cuda.current_stream(device).cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(library(), entry)(*cargs, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def check_operand(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device, dtype=torch.int32) -> None:
    """Refuse what a kernel does not take: wrong device, type, shape, or a
    non-contiguous or misaligned tensor."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
