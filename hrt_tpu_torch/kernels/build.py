"""Build and load the CUDA kernels of `hrt_tpu_torch/csrc/`.

Every `csrc/*.cu` file compiles to an object in its own nvcc process,
all started together, and one more nvcc call links them into a shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<file>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library lands in the package's `_build/` directory under a name
keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once.  Building happens at the first
`load()`; nvcc's ptxas report (registers, spills) is kept beside it as
`<name>.log`.  A missing nvcc or a failed build raises with nvcc's
stderr.  No fast-math: FMA contraction stays on, as nvcc's default.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda; raises if absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libhrt_kernels-{h.hexdigest()[:16]}.so")


def build_once(path: str, stages_for, what: str, timeout: int) -> None:
    """Build `path` unless it exists, under a lock so that parallel
    processes build it once.  `stages_for(tmp)` gives the build as a
    list of stages, each a list of commands that run at the same time;
    the last stage must write `tmp`.  The commands' stderr is kept
    beside `path` as `<name>.log`.  Raises with a failed command's
    stderr."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lock_path = os.path.join(os.path.dirname(path), ".build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        log = []
        for stage in stages_for(tmp):
            procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for argv in stage]
            try:
                outs = [p.communicate(timeout=timeout) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, (_, err) in zip(procs, outs):
                log.append(err)
                if p.returncode != 0:
                    raise RuntimeError(f"{what} failed ({p.returncode}):\n"
                                       f"{err}")
        with open(os.path.splitext(path)[0] + ".log", "w") as f:
            f.write("".join(log))
        os.replace(tmp, path)


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path."""
    path = lib_path()
    cu = [s for s in _sources() if s.endswith(".cu")]
    nvcc = nvcc_path()

    def stages(tmp):
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
        return [[[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                 for src, obj in zip(cu, objs)],
                [[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]]]

    try:
        build_once(path, stages, "nvcc", timeout=900)
    finally:
        for leftover in glob.glob(f"{path}.*.tmp.*.o"):
            os.remove(leftover)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    from ..ops import shade_kernel

    cdll = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.hrt_bvh8_trace.restype = i
    cdll.hrt_bvh8_trace.argtypes = [p] * 7 + [i, p, p, i, ctypes.c_float,
                                              i, i] + [p] * 5 + [p]
    cdll.hrt_tlas8_trace.restype = i
    cdll.hrt_tlas8_trace.argtypes = [p] * 7 + [i, p, p, p, p, i, i,
                                               ctypes.c_float, i, i] \
        + [p] * 6 + [p]
    cdll.hrt_skip_trace.restype = i
    cdll.hrt_skip_trace.argtypes = [p] * 7 + [i, p, p, i, i, ctypes.c_float,
                                              i] + [p] * 5 + [p]
    cdll.hrt_tlas_skip_trace.restype = i
    cdll.hrt_tlas_skip_trace.argtypes = [p] * 7 + [i, p, p, p, p, i,
                                                   ctypes.c_float, i, i] \
        + [p] * 6 + [p]
    cdll.hrt_brdf_light_major.restype = i
    cdll.hrt_brdf_light_major.argtypes = [shade_kernel.BrdfArgs, p]
    cdll.hrt_warp_bilinear.restype = i
    cdll.hrt_warp_bilinear.argtypes = [p, i, i, i, i, i, i, p, p, i, p, p,
                                         p]
    cdll.hrt_warp_bilinear_backward.restype = i
    cdll.hrt_warp_bilinear_backward.argtypes = [p, i, i, i, p, p, i, i, p,
                                                p]
    cdll.hrt_cuda_error_string.restype = ctypes.c_char_p
    cdll.hrt_cuda_error_string.argtypes = [i]
    _lib = cdll
    return _lib


def stream(device: torch.device) -> int:
    """The raw handle of `device`'s current stream, as PyTorch's own
    generated kernels read it (cheaper than current_stream())."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = load().hrt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
