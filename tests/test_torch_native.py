"""JAX's native SAH builder, made sure of for the port's parity tests.

`hrt_tpu.native.lib()` builds `native/libhrt_native.so` with an unlocked
`make -C native` when the file is missing, and when that build or the
load fails it keeps None for the life of the process; from then on
`hrt_tpu.ops.lbvh.build_bvh_sah` quietly falls back to the LBVH.  Under
pytest-xdist every worker imports tests/test_native.py, whose
module-level `native.lib()` starts that build in all workers at once,
and a worker that finds the library half written loses the native
builder.  The port's SAH build is always native (hrt_tpu_torch/native.py,
locked and atomic), so a parity test in such a worker would hold the
port's SAH tables against JAX's LBVH and fail.

`jax_native_lib()` takes that out of the tests' hands: under a lock
shared by every process of the machine, it rebuilds the library to a
temporary name, moves it into place in one step and lets the module
load it again, and it raises if JAX's builder still does not load.
Every port test file that reaches JAX's `build_bvh_sah` (directly,
through bench.py, JAX's FrameLoop or `tlas.build_two_level_flat`) calls
it from a module-scoped autouse fixture.
"""
import fcntl
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

from hrt_tpu import native as jnative

LOCK_PATH = os.path.join(tempfile.gettempdir(), "hrt_tpu-native-lib.lock")
CAUSE = ("JAX's native SAH builder did not load; its build_bvh_sah would "
         "fall back to the LBVH")


def jax_native_lib():
    """`hrt_tpu.native.lib()`, loaded.  If it gives None (a build that
    raced another process's, or a half-written library), build the
    library again to a temporary name under `hrt_tpu.native._NATIVE_DIR`,
    move it onto `_LIB_PATH` and load it anew, all under a file lock.
    Raises RuntimeError if it still does not load."""
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cdll = jnative.lib()
        if cdll is not None:
            return cdll
        tmp = f"{jnative._LIB_PATH}.{os.getpid()}.tmp"
        try:
            run = subprocess.run(
                ["make", "-C", jnative._NATIVE_DIR, f"TARGET={tmp}"],
                capture_output=True, text=True, timeout=300)
            if run.returncode != 0:
                raise RuntimeError(f"{CAUSE}: `make -C {jnative._NATIVE_DIR}` "
                                   f"failed ({run.returncode}):\n"
                                   f"{run.stdout}{run.stderr}")
            os.replace(tmp, jnative._LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        jnative._tried = False
        jnative._lib = None
        cdll = jnative.lib()
        if cdll is None:
            raise RuntimeError(f"{CAUSE}: {jnative._LIB_PATH} was rebuilt "
                               "but does not load")
        return cdll


def _native_copy(tmp_path, makefile=None):
    """native/'s sources in a directory of their own, with `makefile`
    in place of the Makefile when given."""
    src = jnative._NATIVE_DIR
    dst = tmp_path / "native"
    dst.mkdir()
    for name in os.listdir(src):
        if name.endswith((".cpp", ".h", ".hpp", "Makefile")):
            shutil.copy(os.path.join(src, name), dst / name)
    if makefile is not None:
        (dst / "Makefile").write_text(makefile)
    return str(dst)


def _point_at(monkeypatch, native_dir):
    """hrt_tpu.native as a worker that lost the build race sees it: the
    load tried once and failed, against `native_dir`'s library."""
    monkeypatch.setattr(jnative, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(jnative, "_LIB_PATH",
                        os.path.join(native_dir, "libhrt_native.so"))
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)


def test_lost_race_restores_the_native_builder(tmp_path, monkeypatch):
    """A worker whose load failed on a truncated library: the helper
    rebuilds it and JAX's build_bvh_sah, which fell back to the LBVH,
    then gives the port's SAH BVH8 table bit for bit."""
    from hrt_tpu.ops import lbvh as jlbvh
    from hrt_tpu_torch.ops import lbvh
    from hrt_tpu_torch.utils.interop import scene_from_numpy
    from test_fuzz import random_scene_data
    from test_torch_build import jax_scene_dict

    jax_native_lib()
    with open(jnative._LIB_PATH, "rb") as f:
        head = f.read(4096)
    native_dir = _native_copy(tmp_path)
    lib_path = os.path.join(native_dir, "libhrt_native.so")
    with open(lib_path, "wb") as f:
        f.write(head)
    _point_at(monkeypatch, native_dir)
    data = random_scene_data(2, n_tris=600)[0]
    tris = [np.asarray(a) for a in (data.tri_v0, data.tri_e1, data.tri_e2)]
    valid = (np.asarray(data.tri_valid) > 0.5).astype(np.int32)
    assert jnative.sah_build(*tris, valid, 8) is None  # LBVH fallback

    cdll = jax_native_lib()
    assert cdll is not None and jnative.lib() is cdll
    assert os.path.getsize(lib_path) > len(head)
    assert not [n for n in os.listdir(native_dir) if n.endswith(".tmp")]
    ja = jlbvh.build_bvh_sah(data, leaf_size=8)
    ta = lbvh.build_bvh_sah(scene_from_numpy(jax_scene_dict(data), "cpu"),
                            leaf_size=8)
    want = ta.w8.numpy().view(np.int32)
    np.testing.assert_array_equal(np.asarray(ja.w8).view(np.int32), want)
    np.testing.assert_array_equal(np.asarray(ja.tree.tri_perm),
                                  ta.tri_perm.numpy())


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that cannot succeed raises and names the cause; it never
    hands back None for the LBVH fallback."""
    native_dir = _native_copy(
        tmp_path, makefile="all:\n\t@echo no compiler here >&2; exit 3\n")
    _point_at(monkeypatch, native_dir)
    with pytest.raises(RuntimeError, match="fall back to the LBVH") as err:
        jax_native_lib()
    assert "no compiler here" in str(err.value)
    assert jnative._lib is None
    assert not [n for n in os.listdir(native_dir) if n.endswith(".tmp")]


def test_loaded_library_is_kept(monkeypatch):
    """With the library loaded, the helper returns it as it is and
    builds nothing."""
    cdll = jax_native_lib()

    def no_build(*args, **kwargs):
        raise AssertionError("jax_native_lib rebuilt a loaded library")

    monkeypatch.setattr(subprocess, "run", no_build)
    assert jax_native_lib() is cdll is jnative.lib()
