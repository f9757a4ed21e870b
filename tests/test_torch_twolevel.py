"""hrt_tpu_torch.ops.twolevel (the stacked two-level accel: an LBVH per
mesh walked by K3's plain version here, the instances' boxes and
transforms) against the JAX package's on test_twolevel's scene and
rays.  The JAX builds and traces are compiled once, in module
fixtures."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hrt_tpu.models.instance import MeshInstance as JMeshInstance
from hrt_tpu.ops import twolevel as jtwolevel
from hrt_tpu_torch.models.instance import MeshInstance
from hrt_tpu_torch.ops import intersect, twolevel

from test_torch_tlas import port_scene
from test_twolevel import make_scene, rays

N_RAYS = 2048


@pytest.fixture(scope="module")
def built():
    sc = make_scene()
    return (jtwolevel.build_two_level(sc, leaf_size=8),
            twolevel.build_two_level(port_scene(sc), 8, device="cpu"))


@pytest.fixture(scope="module")
def traced(built):
    """Both packages' closest hits on the same rays (seeds 0 and 5)."""
    jacc, acc = built
    out = []
    for seed in (0, 5):
        o, d = rays(N_RAYS, seed)
        j = [np.asarray(a) for a in jtwolevel.trace_two_level(
            jacc, o, d, 1e32, leaf_size=8)]
        t = [a.numpy() for a in twolevel.trace_two_level(
            acc, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)))]
        out.append((o, d, j, t))
    return out


def test_blas_tables_match_jax(built):
    """Each mesh's LBVH leaf order and its shading tables equal JAX's
    (the same bit-equal LBVH build)."""
    jacc, acc = built
    for m, blas in enumerate(acc.blas):
        np.testing.assert_array_equal(blas.tri_perm.numpy(),
                                      np.asarray(jacc.tree.tri_perm[m]))
    for k in ("nrm0", "nrm1", "nrm2", "uv0", "uv1", "uv2",
              "inst_bmin", "inst_bmax", "world_from_obj",
              "obj_from_world", "normal_mat"):
        np.testing.assert_array_equal(getattr(acc, k).numpy(),
                                      np.asarray(getattr(jacc, k)), k)
    np.testing.assert_array_equal(acc.inst_mesh.numpy(),
                                  np.asarray(jacc.inst_mesh))


def test_trace_matches_jax(traced):
    """Instance and leaf-pool triangle ids equal on >= 0.999 of rays
    (equal-t ties may differ with walk order), t within 2e-4 where
    they agree (the object-space transform rounds differently)."""
    for _, _, (jt, ji, jtri, ju, jv), (t, inst, tri, u, v) in traced:
        same = (inst == ji) & (tri == jtri)
        assert same.mean() >= 0.999
        hit = same & (ji >= 0)
        assert 0.1 < hit.mean() < 0.9
        np.testing.assert_allclose(t[hit], jt[hit], rtol=0, atol=2e-4)
        np.testing.assert_allclose(u[hit], ju[hit], rtol=0, atol=2e-4)
        np.testing.assert_allclose(v[hit], jv[hit], rtol=0, atol=2e-4)
        assert (t[ji < 0] == 1e32).all() and (tri[ji < 0] == -1).all()


def test_shade_attrs_match_jax(built, traced):
    """Normals, UVs and materials within 1e-5 where the hits agree."""
    jacc, acc = built
    for _, _, (jt, ji, jtri, ju, jv), (t, inst, tri, u, v) in traced:
        jn, juv, jm = [np.asarray(a) for a in jtwolevel.shade_attrs_two_level(
            jacc, jnp.asarray(ji), jnp.asarray(jtri), jnp.asarray(ju),
            jnp.asarray(jv))]
        n, uv, m = [a.numpy() for a in twolevel.shade_attrs_two_level(
            acc, *(torch.as_tensor(a) for a in (inst, tri, u, v)))]
        hit = (inst == ji) & (tri == jtri) & (ji >= 0)
        np.testing.assert_allclose(n[hit], jn[hit], rtol=0, atol=1e-5)
        np.testing.assert_allclose(uv[hit], juv[hit], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(m[hit], jm[hit])


def test_any_hit_mode_matches_closest(built, traced):
    """Any-hit mode: inst >= 0 exactly where the closest walk hits, and
    within a segment shorter than the hit it finds nothing."""
    _, acc = built
    for o, d, _, (t, inst, _, _, _) in traced:
        o, d = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
        occ = twolevel.trace_two_level(acc, o, d, find_closest=False)[1]
        np.testing.assert_array_equal(occ.numpy() >= 0, inst >= 0)
        short = torch.as_tensor(np.where(inst >= 0, t * 0.99, 1e32))
        occ = twolevel.trace_two_level(acc, o, d, short,
                                       find_closest=False)[1]
        assert (occ.numpy() < 0).all()


def test_matches_flattened_bruteforce(built, traced):
    """The closest hit's t equals brute force over the scene flattened
    to world space, where both hit (the instance transforms are
    exact)."""
    _, acc = built
    flat = port_scene(make_scene()).build("cpu")
    o, d, _, (t, inst, _, _, _) = traced[0]
    bt, bi, _, _ = intersect.closest_hit_bruteforce(
        torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        flat.tri_v0, flat.tri_e1, flat.tri_e2)
    bi = bi.numpy()
    assert ((bi >= 0) == (inst >= 0)).mean() > 0.995
    both = (bi >= 0) & (inst >= 0)
    np.testing.assert_allclose(t[both], bt.numpy()[both], rtol=2e-4,
                               atol=2e-4)
    assert (flat.tri_inst.numpy()[bi[both]] == inst[both]).mean() > 0.98


def test_instance_move_matches_jax(built):
    """Moving an instance is a change of its rows (box and transforms):
    no BLAS rebuilt; a ray that missed now hits the moved ball, as in
    JAX."""
    jacc, acc = built
    o = np.asarray([[4.0, 0.0, -5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    _, inst0, *_ = twolevel.trace_two_level(acc, torch.tensor(o),
                                            torch.tensor(d))
    assert int(inst0[0]) == -1
    box = (np.asarray([3.0, -1.0, -1.0], np.float32),
           np.asarray([5.0, 1.0, 1.0], np.float32))
    moved, jmoved = MeshInstance(0, 0, (4.0, 0.0, 0.0)), JMeshInstance(
        0, 0, (4.0, 0.0, 0.0))

    def put(a, row):
        a = a.clone()
        a[0] = torch.as_tensor(np.asarray(row, np.float32))
        return a

    acc2 = acc._replace(
        inst_bmin=put(acc.inst_bmin, box[0]),
        inst_bmax=put(acc.inst_bmax, box[1]),
        world_from_obj=put(acc.world_from_obj, moved.transform),
        obj_from_world=put(acc.obj_from_world, moved.inverse_transform))
    jacc2 = jacc._replace(
        inst_bmin=jacc.inst_bmin.at[0].set(jnp.asarray(box[0])),
        inst_bmax=jacc.inst_bmax.at[0].set(jnp.asarray(box[1])),
        world_from_obj=jacc.world_from_obj.at[0].set(
            jnp.asarray(jmoved.transform)),
        obj_from_world=jacc.obj_from_world.at[0].set(
            jnp.asarray(jmoved.inverse_transform)))
    t1, inst1, tri1, _, _ = twolevel.trace_two_level(
        acc2, torch.tensor(o), torch.tensor(d))
    jt1, jinst1, jtri1, _, _ = jtwolevel.trace_two_level(
        jacc2, jnp.asarray(o), jnp.asarray(d), 1e32, leaf_size=8)
    assert int(inst1[0]) == int(jinst1[0]) == 0
    assert int(tri1[0]) == int(jtri1[0])
    np.testing.assert_allclose(float(t1[0]), float(jt1[0]), atol=2e-4)
