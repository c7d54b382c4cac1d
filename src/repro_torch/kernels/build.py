"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel module of ``repro_torch.kernels`` registers its source here
(``register``): the file under ``csrc/``, the C symbol it exports and that
symbol's argument types.  The sources are compiled at first use with
``nvcc`` for ``sm_90a`` into shared libraries with a plain C interface
(loaded with ``ctypes``), under ``build/kernels/`` at the repository root,
keyed by a hash of the source and the flags.  ``build_kernels`` starts one
``nvcc`` per source that is not built yet, all together.

Every source is built with ``--fmad=false``: the DP kernels need it for
bit-identity with the host DP, and the integer kernels do not care, so one
flag set serves all.

``LAUNCHES`` counts kernel launches per kernel (``launch`` adds one per
launch; plain-version calls do not count).  Loading and building are safe
from any thread (the query server's planner thread may be the first to
launch ``dp_sweep``): one lock covers both, and each build writes a
temporary file named for its process and thread.  ``upload`` hands a kernel a
host-built table without waiting for the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# argument types
P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double

SOURCES: dict = {}        # kernel name -> source file under csrc/
_SIGNATURES: dict = {}    # kernel name -> (C symbol, ctypes argtypes)
LAUNCHES: dict = {}       # kernel name -> launches (plain calls not counted)
BUILD_LOG: dict = {}      # nvcc's stderr per kernel (ptxas register report)
_LIBS: dict = {}
# held while a library is built or loaded into _LIBS (reentrant: _lib calls
# build_kernels under it)
_LOCK = threading.RLock()


def register(name: str, source: str, symbol: str, argtypes: list) -> None:
    """Add a kernel to the registry: ``source`` under ``csrc/`` exports
    ``int symbol(argtypes..., void* stream)`` returning a ``cudaError_t``."""
    SOURCES[name] = source
    _SIGNATURES[name] = (symbol, list(argtypes) + [P])
    LAUNCHES.setdefault(name, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "kernels"


def _lib_path(name: str) -> Path:
    # the key covers the shared headers too, which a source may include
    src = b"".join(p.read_bytes() for p in
                   [_CSRC / SOURCES[name], *sorted(_CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{key}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.environ.get("NVCC")]
    if CUDA_HOME:
        cand.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels cannot be built")


def build_kernels(names: "tuple[str, ...] | None" = None) -> "list[str]":
    """Compile every kernel library (default: all registered) that is not
    built yet: one ``nvcc`` per source, all started together.  Returns the
    names it compiled."""
    with _LOCK:
        jobs = []
        for name in (tuple(SOURCES) if names is None else names):
            out = _lib_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = (out.parent
                   / f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / SOURCES[name])]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        failed = []
        for name, out, tmp, proc in jobs:
            _, err = proc.communicate()
            BUILD_LOG[name] = err.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{BUILD_LOG[name]}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return [j[0] for j in jobs]


def _lib(name: str):
    fn = _LIBS.get(name)
    if fn is None:
        with _LOCK:
            fn = _LIBS.get(name)
            if fn is None:
                build_kernels((name,))
                symbol, argtypes = _SIGNATURES[name]
                fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _LIBS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on PyTorch's current stream, raise on
    a refused launch, and count it."""
    import torch

    rc = _lib(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def upload(x, device):
    """The numpy array ``x`` as a tensor on ``device``.  On a card it goes
    through pinned memory without waiting for the card, so a wrapper can
    hand a kernel a host-built table and stay queued ahead of it."""
    import torch

    t = torch.from_numpy(x)
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def check(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def route(device) -> str:
    """``"plain"`` for CPU tensors, ``"kernel"`` for CUDA tensors; any other
    device raises."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {device}")


def plain(t) -> bool:
    """Whether a wrapper runs its plain version for ``t``: a tensor on the
    CPU that holds data.  A CUDA tensor launches the kernel; a fake tensor,
    or a DTensor over fake shards (the dry-run's, shapes only), goes through
    the kernel's operator, whose shape-only form it dispatches to.  Any
    other device raises."""
    from torch._subclasses.fake_tensor import is_fake

    return route(t.device) == "plain" and not is_fake(t)


def wants_grad(*tensors) -> bool:
    """Whether autograd is on and one of ``tensors`` requires a gradient:
    a wrapper then goes through its kernel's autograd Function."""
    import torch

    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
