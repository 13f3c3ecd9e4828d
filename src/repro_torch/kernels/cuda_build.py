"""Build, load and launch the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface
(``<name>_launch``), compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout and loaded with
``ctypes``. A library's file name carries the hash of its sources, so an
edited source is never served by a stale library. :func:`build` starts
one ``nvcc`` per missing library, all together.

The kernel modules (``quant_matmul``, ``flash_attention``,
``paged_attention``) describe their sources as :class:`Source` entries
and launch through :func:`launch`, which checks the C function's error
code and counts the launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import (Dict, Iterable, List, MutableMapping, Optional,
                    Sequence, Tuple)

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: the shared Hopper helpers (mbarriers, TMA, wgmma descriptors), as a
#: header path relative to a kernel module's ``csrc``
HOPPER_HEADER = "../../csrc/hopper.cuh"

P = ctypes.c_void_p
I = ctypes.c_int     # noqa: E741
F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Source:
    """One kernel library: ``csrc/<name>.cu`` (plus the headers it
    includes) exporting ``int <name>_launch(..., void* stream)`` with
    ``argtypes`` before the stream."""

    name: str
    csrc: Path
    argtypes: Tuple
    headers: Tuple[str, ...] = ()

    @property
    def files(self) -> List[Path]:
        return [self.csrc / f"{self.name}.cu"] \
            + [self.csrc / h for h in self.headers]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def library_path(src: Source, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    for f in src.files:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return Path(build_dir) / f"lib{src.name}_{h.hexdigest()[:12]}.so"


def build(sources: Iterable[Source],
          build_dir: Path = BUILD_DIR) -> List[Path]:
    """Compile every library that is missing, one ``nvcc`` per source,
    all started together. Raises with the compiler's output if one
    fails. Returns the library paths."""
    sources = list(sources)
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    outs = [library_path(s, build_dir) for s in sources]
    procs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(src.csrc / f"{src.name}.cu")]
        procs.append((src.name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return outs


_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def _function(src: Source):
    fn = _FUNCS.get(src.name)
    if fn is None:
        lib = ctypes.CDLL(str(build((src,))[0]))
        fn = getattr(lib, f"{src.name}_launch")
        fn.argtypes = list(src.argtypes) + [P]
        fn.restype = ctypes.c_int
        _FUNCS[src.name] = fn
    return fn


def launch(src: Source, counts: MutableMapping[str, int], *args,
           key: Optional[str] = None) -> None:
    """Call ``<name>_launch(*args, stream)`` on the current stream, raise
    if it reports a CUDA error, and add one to ``counts[key]`` (by
    default ``counts[name]``)."""
    rc = _function(src)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{src.name} launch failed: cudaError {rc}")
    counts[key or src.name] += 1


#: per device, the int32 counters of the kernels' in-launch merges of
#: split work (paged attention, the quant decode loop): zeroed once when
#: made, and left at 0 by every launch; the newest last, an older one
#: kept alive, so that a CUDA graph captured over it keeps a valid address
_COUNTERS: Dict[object, List[torch.Tensor]] = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters at 0 on ``device``, shared by every
    launch on it (launches on one stream run one after another)."""
    have = _COUNTERS.setdefault(device.index, [])
    if not have or have[-1].numel() < n:
        have.append(torch.zeros(max(n, 256), dtype=torch.int32,
                                device=device))
    return have[-1]


#: per device, the f32 workspaces of the quant decode loop's merge, the
#: newest last; an older one stays alive, so that a CUDA graph captured
#: over it keeps a valid address
_WORKSPACES: Dict[object, List[torch.Tensor]] = {}


def workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` float32 elements of scratch on ``device``, shared by
    every launch on it (launches on one stream run one after another, and
    a launch reads only what it wrote itself), so that a call allocates
    nothing once warm."""
    have = _WORKSPACES.setdefault(device.index, [])
    if not have or have[-1].numel() < n:
        size = max(n, 2 * have[-1].numel()) if have else n
        have.append(torch.empty(size, dtype=torch.float32, device=device))
    return have[-1]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """The device address of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check(name: str, t: torch.Tensor, dtype, shape: Sequence[int],
          device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` and ``shape``
    and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
