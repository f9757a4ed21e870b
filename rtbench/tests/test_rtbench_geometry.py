import numpy as np
import pytest

from hrt_tpu_torch.models import mesh as port_mesh
from rtbench import geometry


@pytest.mark.parametrize("sub", [0, 1, 2, 3, 4])
def test_vectorised_icosphere_equals_the_dict_loop(sub):
    ours = geometry.icosphere(sub)
    port = port_mesh.icosphere(sub)
    assert np.array_equal(ours.indices, port.indices)
    assert np.array_equal(ours.positions, port.vertices[:, 0:3])
    assert np.array_equal(ours.normals, port.vertices[:, 3:6])
    assert np.array_equal(ours.uvs, port.vertices[:, 6:8])


def test_plane_equals_the_programs():
    ours = geometry.plane(8.0)
    port = port_mesh.plane(8.0)
    assert np.array_equal(np.concatenate([ours.positions, ours.normals,
                                          ours.uvs], 1), port.vertices)
    assert np.array_equal(ours.indices, port.indices)


def test_bigmesh_triangle_count():
    from rtbench import manifest
    cfg = manifest.config("bigmesh_2m6")
    cfg["meshes"]["big"]["subdivisions"] = 2
    assert geometry.num_triangles(geometry.scene_arrays(cfg)) == \
        2 * 20 * 4 ** 2 + 2
    assert 2 * 20 * 4 ** 8 + 2 == 2621442
