"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled on first use into its own shared library with
a plain C interface (no PyTorch headers, so each build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<hash>/lib<name>.so

One nvcc per source, all started together.  ``<hash>`` is a digest of every
source and header under ``csrc/`` and of the flags, so an edited source
rebuilds and an unchanged tree reuses what is on disk.  The compiler's
output (``-Xptxas=-v``: registers, shared memory, spills per kernel) is kept
beside each library as ``<name>.log``.  A failed build raises; nothing falls
back to the plain versions.

Wrappers pass every pointer and the stream as ``ctypes.c_void_p`` and each C
entry point returns ``cudaGetLastError()`` after its launch, which
``check`` turns into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the CUDA kernels cannot be built"
        )
    return found


def build_dir() -> Path:
    """The directory this source tree's libraries live in."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source whose library is missing, in parallel."""
    out_dir = build_dir()
    todo = [
        s for s in sorted(CSRC.glob("*.cu"))
        if not (out_dir / f"lib{s.stem}.so").exists()
    ]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of ``lib<name>.so`` with its argument types set
    (looked up once)."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of a card (asked once per card)."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def on_device(device: torch.device):
    """A context in which ``device`` is the current card: no switch when it
    is already (the launch goes to the current card's context)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} (error {err})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; a ``None`` entry of ``shape`` matches any size."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
