"""ctypes binding of the shared native library: the SAH builder
(native/sah_bvh.cpp) and the OBJ loader (native/objloader.cpp).

The library is built with `make -C native` at first use, into this
package's `_build/` directory under a name keyed by the sources' hash
(so it never races the JAX package's own `native/libhrt_native.so`),
by the same locked build step as the CUDA kernels.
There is no fallback builder: if the library cannot be built or loaded,
`lib()` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from .kernels import build

_NATIVE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, "native"))
_lib: ctypes.CDLL | None = None


class _ObjMesh(ctypes.Structure):
    _fields_ = [("vertices", ctypes.POINTER(ctypes.c_float)),
                ("n_vertices", ctypes.c_int),
                ("indices", ctypes.POINTER(ctypes.c_int)),
                ("n_tris", ctypes.c_int)]


def _lib_path() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(_NATIVE_DIR)):
        if name.endswith((".cpp", "Makefile")):
            with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(build.BUILD_DIR,
                        f"libhrt_native-{h.hexdigest()[:16]}.so")


def lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    build.build_once(
        path, lambda tmp: [[["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"]]],
        "building the native SAH library", timeout=300)
    cdll = ctypes.CDLL(path)
    cdll.obj_load.restype = ctypes.c_int
    cdll.obj_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjMesh)]
    cdll.obj_free.restype = None
    cdll.obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
    cdll.sah_build.restype = ctypes.c_int
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    cdll.sah_build.argtypes = [
        f32p, f32p, f32p, i32p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, f32p, f32p, f32p, f32p,
        i32p, f32p, f32p, ctypes.POINTER(ctypes.c_int),
    ]
    _lib = cdll
    return _lib


def sah_build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              valid: np.ndarray, leaf_size: int) -> dict:
    """Binned-SAH build over (T, 3) triangle arrays.  Returns numpy
    arrays: child_l/r (Ni,), child boxes (Ni, 3), leaf_tri (NL, K) with
    -1 padding, leaf_min/max (NL, 3).  Raises ValueError when no
    triangle is valid."""
    cdll = lib()
    t = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    valid = np.ascontiguousarray(valid, np.int32)
    child_l = np.zeros(t, np.int32)
    child_r = np.zeros(t, np.int32)
    bl_min = np.zeros((t, 3), np.float32)
    bl_max = np.zeros((t, 3), np.float32)
    br_min = np.zeros((t, 3), np.float32)
    br_max = np.zeros((t, 3), np.float32)
    leaf_tri = np.zeros(2 * t + leaf_size, np.int32)
    leaf_min = np.zeros((t + 1, 3), np.float32)
    leaf_max = np.zeros((t + 1, 3), np.float32)
    n_leaf = ctypes.c_int(0)
    ni = cdll.sah_build(v0, e1, e2, valid, t, leaf_size, child_l, child_r,
                        bl_min.reshape(-1), bl_max.reshape(-1),
                        br_min.reshape(-1), br_max.reshape(-1),
                        leaf_tri, leaf_min.reshape(-1),
                        leaf_max.reshape(-1), ctypes.byref(n_leaf))
    nl = n_leaf.value
    if nl == 0:
        raise ValueError("SAH build: the scene has no valid triangles")
    return {
        "child_l": child_l[:ni].copy(),
        "child_r": child_r[:ni].copy(),
        "bmin_l": bl_min[:ni].copy(), "bmax_l": bl_max[:ni].copy(),
        "bmin_r": br_min[:ni].copy(), "bmax_r": br_max[:ni].copy(),
        "leaf_tri": leaf_tri[: nl * leaf_size].reshape(nl, leaf_size)
        .copy(),
        "leaf_min": leaf_min[:nl].copy(),
        "leaf_max": leaf_max[:nl].copy(),
    }


def load_obj(path: str):
    """Parse an OBJ file: (vertices (V, 8) float32, indices (T, 3)
    int32), Y negated on positions and normals (the reference's y-down
    convention), vertices deduplicated on their full record, polygons
    fan-triangulated.  Raises FileNotFoundError when the file cannot be
    read or parsed."""
    cdll = lib()
    mesh = _ObjMesh()
    rc = cdll.obj_load(os.fsencode(path), ctypes.byref(mesh))
    if rc != 0:
        raise FileNotFoundError(f"obj_load({path!r}) failed with {rc}")
    try:
        verts = np.ctypeslib.as_array(mesh.vertices,
                                      (mesh.n_vertices, 8)).copy()
        idx = np.ctypeslib.as_array(mesh.indices, (mesh.n_tris, 3)).copy()
    finally:
        cdll.obj_free(ctypes.byref(mesh))
    return verts, idx
