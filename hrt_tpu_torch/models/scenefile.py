"""Built-in benchmark scenes of hrt_tpu/models/scenefile.py: the Cornell
box.  The YAML scene loader is not ported yet."""
from __future__ import annotations

import math

from . import mesh as mesh_mod
from .scene import Scene


def cornell_box(light_intensity: float = 2.5) -> Scene:
    """The classic Cornell box, y-down: interior [-1, 1]^3, a tall
    mirror block and a short white block, one point light under the
    ceiling, a black sky; the camera looks down +z from z ~ -3.2."""
    sc = Scene()
    wall = sc.add_mesh(mesh_mod.plane(1.0))
    box = sc.add_mesh(mesh_mod.cube(1.0))

    white = sc.create_material((0.73, 0.73, 0.73), 0.0, 1.0)
    red = sc.create_material((0.65, 0.05, 0.05), 0.0, 1.0)
    green = sc.create_material((0.12, 0.45, 0.15), 0.0, 1.0)
    metal = sc.create_material((0.8, 0.85, 0.88), 1.0, 0.05)

    # y-down: floor at y = +1, ceiling at y = -1.
    sc.create_instance(wall, white, (0, 1, 0))                       # floor
    sc.create_instance(wall, white, (0, -1, 0), (math.pi, 0, 0))     # ceil
    sc.create_instance(wall, white, (0, 0, 1),
                       (-math.pi / 2, 0, 0))                         # back
    sc.create_instance(wall, red, (-1, 0, 0), (0, 0, -math.pi / 2))  # left
    sc.create_instance(wall, green, (1, 0, 0), (0, 0, math.pi / 2))  # right
    sc.create_instance(box, metal, (-0.35, 0.4, 0.3), (0, 0.3, 0),
                       (0.3, 0.6, 0.3))
    sc.create_instance(box, white, (0.4, 0.7, -0.3), (0, -0.25, 0),
                       (0.28, 0.3, 0.28))

    sc.create_light((0.0, -0.85, 0.0), (1.0, 1.0, 1.0), light_intensity)
    sc.set_sky(brightness=0.0)
    return sc
