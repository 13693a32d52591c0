"""Build and load the port's CUDA kernels; count their launches.

The kernels are CUDA C++ for ``sm_90a`` under ``mixermdm_tpu_torch/csrc``,
built with plain ``nvcc`` (no PyTorch headers, so a build takes seconds) into
one shared library that :mod:`ctypes` loads.  The build runs at first use:
one ``nvcc -c`` per source, all started together, then one link.

The output directory ``_build/<hash>/`` is keyed on a hash of the sources and
flags, so a library built from other sources is never reused.  Each build
writes into a fresh temporary directory and renames it into place when it is
complete, so a half-written build is never picked up and there is no lock
file to wait on.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("adaln.cu", "linear.cu", "attention.cu", "attention_bwd.cu", "quant.cu", "linear_q8.cu",
           "sa_block.cu", "sa_block_i8x.cu")
HEADERS = ("common.cuh", "gemm_sm90.cuh", "wgmma.cuh", "sa_common.cuh", "tf32.cuh")
LIB_NAME = "libmixermdm_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launches per kernel and per entry point, counted by the wrappers where they
# launch on the card (never on the CPU path).  Read and reset by callers that
# need to show a run went through the kernels.
launches: collections.Counter = collections.Counter()
# The same launches by (name, *shape) where the wrapper gives a shape (the
# GEMM routes: M, K, N, epilogue; the attention kernels: B, H, Tq, Tk, D;
# the AdaLN prologues: B, T, E), for a histogram of a run.
launch_shapes: collections.Counter = collections.Counter()


class ShapeRefused(ValueError):
    """A fused kernel's launch plan does not take this shape."""


class NoClusterFits(RuntimeError):
    """No thread block cluster of a fused kernel's launch plan fits the card."""


# What a fused kernel's plan raises when it refuses a launch: its callers
# may take another kernel route then.  A CUDA error is neither.
PLAN_REFUSALS = (ShapeRefused, NoClusterFits)


def reset_launch_counts() -> None:
    launches.clear()
    launch_shapes.clear()


# The one switch between the kernels and their plain versions.  The entry
# points take their plain versions for CPU tensors; inside
# :func:`plain_versions` they take them for CUDA tensors too, so a caller can
# hold a whole network on the kernels against the same network without
# them.  The host's native motion library (``data/native.py``) takes its
# numpy plain version inside it too.  Nothing else routes around the kernels.
_plain_on_card = False


@contextlib.contextmanager
def plain_versions():
    """Run every entry point's plain version, on any device, inside the
    block (no kernel launches, nothing counted)."""
    global _plain_on_card
    prev, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = prev


def plain_requested() -> bool:
    """Whether the caller is inside :func:`plain_versions` (host code, which
    has no tensor to ask :func:`use_plain` about)."""
    return _plain_on_card


def use_plain(x) -> bool:
    """Whether an entry point given ``x`` runs its plain version: ``x`` is
    on the CPU, or the caller is inside :func:`plain_versions`."""
    return _plain_on_card or x.device.type == "cpu"


def find_nvcc() -> str:
    candidates = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the kernels need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(COMPILE_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> tuple[str, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns ``(library_path, compiler_log)``; the log is empty when an
    existing build was reused.
    """
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path, ""
    nvcc = find_nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    try:
        t0 = time.time()
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc, *COMPILE_FLAGS, "-I", CSRC_DIR, "-c", os.path.join(CSRC_DIR, src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(log))
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", os.path.join(tmp, LIB_NAME),
                *[obj for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {res.returncode})\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        log.append(f"== built in {time.time() - t0:.1f} s")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.isfile(lib_path):  # not a finished build from a racing process
                raise
        return lib_path, "\n".join(log)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# The argument types of every ``extern "C"`` launcher in ``csrc/*.cu``: a
# c_void_p for each pointer and the stream (ctypes would pass a bare Python
# int as 32 bits), c_int64 for ``long long``.  tests/test_torch_port_gemm.py
# holds this table against the sources.
ARGTYPES = {
    "mm_adaln_modulate": [_vp, _vp, _i64, _vp, _i64, _vp, _i32, _i32, _i32, _f32, _vp],
    "mm_adaln_modulate_q8": [_vp, _vp, _i64, _vp, _i64, _vp, _vp, _i32, _i32, _i32, _f32, _vp],
    "mm_linear_tma": [_vp, _i64, _vp, _i64, _vp, _vp, _i64, _vp, _i64, _i32, _i32, _i32, _i32,
                      _i32, _i32, _i32, _i32, _vp],
    "mm_linear_skinny": [_vp, _i64, _vp, _i64, _vp, _vp, _i64, _vp, _i64, _i32, _i32, _i32, _i32,
                         _vp],
    "mm_linear_ragged": [_vp, _i64, _vp, _i64, _vp, _vp, _i64, _vp, _i64, _i32, _i32, _i32, _i32,
                         _i32, _i32, _i32, _i32, _vp],
    "mm_linear_init": [],
    "mm_attention": [_vp, _vp, _vp, _vp, ctypes.POINTER(_i64), _vp, _vp, _vp,
                     _i32, _i32, _i32, _i32, _i32, _i32, _f32, _i32, _i32, _i32, _i32, _i32,
                     _vp],
    "mm_attention_init": [],
    "mm_attention_q8": [_vp, _vp, _vp, _vp, ctypes.POINTER(_i64), _vp, _vp,
                        _i32, _i32, _i32, _i32, _i32, _i32, _f32, _i32, _i32, _i32, _vp],
    "mm_attention_q8_clusters": [_i32, _i32, _i32, _i32],
    "mm_attention_bwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                         _i32, _i32, _i32, _i32, _i32, _f32, _i32, _i32, _i32, _vp],
    "mm_attention_bwd_init": [],
    "mm_quant_rows": [_vp, _i32, _vp, _vp, _i32, _i32, _vp],
    "mm_linear_q8": [_vp, _i64, _vp, _vp, _i64, _vp, _vp, _vp, _i64, _vp, _i64,
                     _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp],
    "mm_linear_q8_init": [],
    "mm_linear_q8_gelu_q8": [_vp, _i64, _vp, _vp, _i64, _vp, _vp, _vp, _i64, _vp,
                             _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp],
    "mm_linear_q8_gelu_q8_clusters": [_i32, _i32, _i32],
    "mm_sa_block": [_vp, _vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                    _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _f32, _f32,
                    _vp, _i32, _vp],
    "mm_sa_block_occupancy": [_i32],
    "mm_sa_block_init": [],
    "mm_sa_block_i8x": [_vp, _vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                        _i32, _i32, _f32, _f32, _f32, _f32, _vp, _i32, _vp],
    "mm_sa_block_i8x_occupancy": [_i32],
    "mm_sa_block_i8x_init": [],
}
# Run once when the library loads, before any launch a graph could capture
# (every kernel's dynamic shared memory limit).
INIT_FUNCTIONS = ("mm_linear_init", "mm_linear_q8_init", "mm_attention_init",
                  "mm_attention_bwd_init", "mm_sa_block_init", "mm_sa_block_i8x_init")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with argtypes set and
    its init functions run."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in INIT_FUNCTIONS:
        rc = getattr(lib, name)()
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return lib


def check_launch(name: str, rc: int, shape: tuple = ()) -> None:
    """Raise if the launcher reported a CUDA error; else count the launch
    (and, given a ``shape``, count it under ``(name, *shape)`` too)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[name] += 1
    if shape:
        launch_shapes[(name, *shape)] += 1


def stream_handle(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_bf16(name: str, *tensors) -> None:
    """The kernels take bf16 tensors on one CUDA device, nothing else."""
    import torch

    require_cuda(name, (torch.bfloat16,), *tensors)


def require_cuda(name: str, dtypes: tuple, *tensors) -> None:
    """Each tensor (None skipped) lies on one CUDA device and has one of
    ``dtypes``."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {' or '.join(map(str, dtypes))} here, "
                            f"got {t.dtype} (other dtypes run on the card only inside "
                            "ops.plain_versions())")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
