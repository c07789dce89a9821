"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  All missing libraries are built together, one ``nvcc`` process
per source.  Libraries land in ``<repo>/build/kernels/`` (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of their source, the headers
they may include (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  A failed
build raises with the compiler's output; nothing falls back to the plain
PyTorch version.

Each wrapper declares its C entry points as ``Entry`` objects, which load
the library, set the ctypes signature, launch on the device's current
stream, raise with the library's ``<name>_error_string`` and count the
launches (``LAUNCHES``), so no wrapper holds a library or a counter.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "flash_attention": CSRC / "flash_attention.cu",
    "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
    "rmsnorm": CSRC / "rmsnorm.cu",
    "rmsnorm_bwd": CSRC / "rmsnorm_bwd.cu",
    "decode_attention": CSRC / "decode_attention.cu",
    "decode_proj": CSRC / "decode_proj.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH or set CUDA_HOME)")


def headers() -> list[Path]:
    """The shared headers in ``csrc/``, which any source may include."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in headers():
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills, shared
    memory per kernel) from the build of ``name``'s current source."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> list[str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the names built."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return []
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        lib = library_path(n)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (cmd, tmp, proc) in procs.items():
        output, _ = proc.communicate()
        lib = library_path(n)
        lib.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"$ {' '.join(cmd)}\n{output}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first if
    any library is missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


_SMS: dict[int, int] = {}  # streaming multiprocessors of each device


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where a view starts off the 16-byte grid
    that the kernels' 16-byte copies need (a fresh allocation is on it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# Launches that returned 0, by library, since the last reset (a launch
# captured in a CUDA graph counts at its capture, not at its replays)
LAUNCHES: dict[str, int] = dict.fromkeys(SOURCES, 0)
# the C types of the entries' signatures
PTR, INT, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Entry:
    """The C entry point ``symbol`` of library ``library``, resolved with
    its signature at the first call.  ``launch`` calls a kernel entry (the
    stream last, an error code back); calling the entry runs a query."""

    def __init__(self, library: str, symbol: str, argtypes, restype=INT):
        self.library, self.symbol = library, symbol
        self.argtypes, self.restype = argtypes, restype
        self._fn = self._message = None

    def _resolve(self):
        lib = load(self.library)
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        message = getattr(lib, f"{self.library}_error_string")
        message.argtypes, message.restype = [INT], ctypes.c_char_p
        self._fn, self._message = fn, message
        return fn

    def __call__(self, *args):
        return (self._fn or self._resolve())(*args)

    def launch(self, index: int, *args) -> None:
        """Launch on device ``index``'s current stream by its raw handle, as
        Triton's and Inductor's launchers do (no ``torch.cuda.Stream`` is
        built; the device is switched only when it is not current); raise
        with the library's words on a nonzero return, else count it."""
        fn = self._fn or self._resolve()
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch._C._cuda_getDevice():
            err = fn(*args, stream)
        else:
            with torch.cuda.device(index):
                err = fn(*args, stream)
        if err:
            raise RuntimeError(f"{self.library} kernel launch failed: "
                               f"{self._message(err).decode()} ({err})")
        LAUNCHES[self.library] += 1
