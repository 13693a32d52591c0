"""ctypes binding of the C++ motion-feature pipeline
(``mixermdm_tpu_torch/csrc/motion_ops.cpp``); counterpart of
``mixermdm_tpu/data/native.py``.

The library is built with ``g++ -O3 -shared -fPIC`` at first use into
``_build/host-<hash>/`` beside the kernels' builds (the hash covers the
source and the flags; the source is not part of the CUDA build).  As there,
each build writes into a fresh temporary directory and renames it into
place, so processes that build at once never load a half-written library.
A failed build raises with the compiler's output: nothing falls back to
numpy on its own.  The numpy functions of :mod:`..utils.features` are the
library's plain version, taken where the caller asks for the plain versions
(``ops.plain_versions()``, the one switch of the package), as the
InterHuman dataset does.

ctypes releases the interpreter lock for each call, which is what lets the
loader's worker threads build items in parallel.  ``calls`` counts the
calls by function.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

from ..ops import _lib

SOURCE = os.path.join(_lib.CSRC_DIR, "motion_ops.cpp")
LIB_NAME = "libmotion_ops.so"
FLAGS = ("-O3", "-shared", "-fPIC")
RAW_STRIDE = 22 * 3 + 21 * 6
FEATS = 262

# Calls of the library by function name; read and reset by callers that
# need to show a run took the native route.
calls: collections.Counter = collections.Counter()
_lock = threading.Lock()
_lib_handle: ctypes.CDLL | None = None


def find_cxx() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no C++ compiler (g++) found; the motion-feature library needs one "
                       "(set CXX)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build(build_root: str | None = None) -> tuple[str, str]:
    """Compile the library if this source hash has no build yet under
    ``build_root`` (default: the package's ``_build``).  Returns
    ``(library_path, compiler_log)``; the log is empty when an existing
    build was reused."""
    build_root = build_root or _lib.BUILD_ROOT
    out_dir = os.path.join(build_root, "host-" + source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path, ""
    cxx = find_cxx()
    os.makedirs(build_root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-host-", dir=build_root)
    try:
        t0 = time.time()
        cmd = [cxx, *FLAGS, SOURCE, "-o", os.path.join(tmp, LIB_NAME)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (rc {res.returncode}):\n{res.stdout}")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.isfile(lib_path):  # not a finished build from a racing process
                raise
        return lib_path, f"{' '.join(cmd)}\n{res.stdout}built in {time.time() - t0:.2f} s"
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


_F = ctypes.POINTER(ctypes.c_float)
ARGTYPES = {
    "process_motion_interhuman": [_F, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                  ctypes.c_int, _F, _F, _F],
    "process_pair_interhuman": [_F, _F, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int64, _F, _F,
                                ctypes.POINTER(ctypes.c_int32)],
}


def library() -> ctypes.CDLL:
    """The loaded library, built on first use, its argument types set."""
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(build()[0])
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


def _count(name: str) -> None:
    with _lock:
        calls[name] += 1


def _clip(motion: np.ndarray, prev_frames: int) -> np.ndarray:
    motion = np.ascontiguousarray(motion, np.float32)
    if motion.ndim != 2 or motion.shape[1] != RAW_STRIDE or motion.shape[0] < 2:
        raise ValueError(f"motion must be (T >= 2, {RAW_STRIDE}), got {motion.shape}")
    if not 0 <= prev_frames < motion.shape[0]:
        raise ValueError(f"prev_frames {prev_frames} outside a clip of {motion.shape[0]} frames")
    return motion


def process_motion_interhuman_native(motion: np.ndarray, feet_thre: float, prev_frames: int,
                                     flip: bool = True):
    """The C++ twin of ``utils.features.process_motion_interhuman`` on a
    (T, 192) clip: ``(feats (T-1, 262), root_quat (1, 4), root_pos (1, 3))``,
    float32."""
    motion = _clip(motion, prev_frames)
    T = motion.shape[0]
    out = np.empty((T - 1, FEATS), np.float32)
    quat = np.empty((4,), np.float32)
    pos = np.empty((3,), np.float32)
    rc = library().process_motion_interhuman(
        motion.ctypes.data_as(_F), T, RAW_STRIDE, ctypes.c_float(feet_thre), prev_frames,
        int(flip), out.ctypes.data_as(_F), quat.ctypes.data_as(_F), pos.ctypes.data_as(_F))
    if rc != 0:
        raise ValueError(f"process_motion_interhuman failed: rc={rc}")
    _count("process_motion_interhuman")
    return out, quat[None], pos[None]


def process_pair_interhuman_native(m1: np.ndarray, m2: np.ndarray, feet_thre: float,
                                   prev_frames: int, max_len: int, flip: bool = True):
    """Both persons canonicalised, person 2 put in person 1's frame
    (reference interhuman.py:208-216) and both zero-padded to ``max_len``
    rows, in one call.  Returns ``(m1, m2, gt_length)`` (``max_len``, 262),
    or None where the pair call does not take the clips (lengths that
    differ, or more than ``max_len + 1`` frames): the caller then takes the
    per-stage route."""
    m1, m2 = _clip(m1, prev_frames), _clip(m2, prev_frames)
    T = m1.shape[0]
    if m2.shape != m1.shape or T - 1 > max_len:
        return None
    out1 = np.empty((max_len, FEATS), np.float32)
    out2 = np.empty((max_len, FEATS), np.float32)
    gt_len = np.empty((1,), np.int32)
    rc = library().process_pair_interhuman(
        m1.ctypes.data_as(_F), m2.ctypes.data_as(_F), T, RAW_STRIDE, ctypes.c_float(feet_thre),
        prev_frames, int(flip), max_len, out1.ctypes.data_as(_F), out2.ctypes.data_as(_F),
        gt_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"process_pair_interhuman failed: rc={rc}")
    _count("process_pair_interhuman")
    return out1, out2, int(gt_len[0])
