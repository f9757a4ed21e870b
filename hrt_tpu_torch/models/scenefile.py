"""Scene files (hrt_tpu/models/scenefile.py): YAML descriptions whose
schema mirrors the Scene authoring API, and the built-in Cornell box.

    meshes:
      - {name: ball, icosphere: {subdivisions: 3, radius: 1.0}}
      - {name: floor, plane: {size: 4.0}}
      - {name: bunny, obj: models/bunny.obj}
    textures:
      - {name: checker, checkerboard: {n: 8}}
      - {name: wood, image: assets/wood.png}
    materials:
      - {name: floor, color: [1, 1, 1], texture: checker}
      - {name: glass, color: [1, 1, 1], transmission: 1.0, ior: 1.5}
    lights:
      - {position: [0, -1.9, 0], color: [1, 1, 1], intensity: 20}
      - {position: [0, -50, 0], color: [1, 1, 1], intensity: 3,
         type: directional, direction: [0.3, 1, 0.2]}
    instances:
      - {mesh: ball, material: glass, position: [0, 0, 0],
         rotation: [0, 0, 0], scale: [1, 1, 1]}
    sky: {brightness: 0.5}

`yaml` is imported by load_scene_yaml and PIL by `image:` textures
only, when they are called.
"""
from __future__ import annotations

import math

from . import lights as lights_mod
from . import mesh as mesh_mod
from . import textures as tex_mod
from .scene import Scene

_LIGHT_TYPES = {"point": lights_mod.POINT, "spot": lights_mod.SPOT,
                "directional": lights_mod.DIRECTIONAL}


def load_scene_yaml(path: str) -> Scene:
    """The Scene a YAML file describes."""
    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f)
    return scene_from_dict(spec)


def scene_from_dict(spec: dict) -> Scene:
    """The Scene a parsed scene description describes (the YAML schema
    above, as dicts and lists)."""
    sc = Scene()
    mesh_ids: dict[str, int] = {}
    mat_ids: dict[str, int] = {}

    for i, m in enumerate(spec.get("meshes", [])):
        name = m.get("name", f"mesh{i}")
        if "obj" in m:
            mid = sc.load_model(m["obj"])
        elif "plane" in m:
            mid = sc.add_mesh(mesh_mod.plane(**(m["plane"] or {})))
        elif "cube" in m:
            mid = sc.add_mesh(mesh_mod.cube(**(m["cube"] or {})))
        elif "icosphere" in m:
            mid = sc.add_mesh(mesh_mod.icosphere(**(m["icosphere"] or {})))
        else:
            raise ValueError(f"mesh '{name}': unknown source {m}")
        mesh_ids[name] = mid

    tex_ids: dict[str, int] = {}
    for i, t in enumerate(spec.get("textures", [])):
        name = t.get("name", f"tex{i}")
        if "image" in t:
            import numpy as np
            from PIL import Image

            img = np.asarray(Image.open(t["image"]).convert("RGB"))
        elif "checkerboard" in t:
            img = tex_mod.checkerboard(**(t["checkerboard"] or {}))
        else:
            raise ValueError(f"texture '{name}': unknown source {t}")
        tex_ids[name] = sc.create_texture(img)

    for i, m in enumerate(spec.get("materials", [])):
        m = dict(m)
        name = m.pop("name", f"mat{i}")
        color = tuple(m.pop("color", (1.0, 1.0, 1.0)))
        metallic = m.pop("metallic", 0.0)
        roughness = m.pop("roughness", 1.0)
        emissive = tuple(m.pop("emissive_color", (0.0, 0.0, 0.0)))
        strength = m.pop("emission_strength", 0.0)
        if "texture" in m:
            m["texture"] = tex_ids[m.pop("texture")]
        mat_ids[name] = sc.create_material(color, metallic, roughness,
                                           emissive, strength, **m)

    for li in spec.get("lights", []):
        sc.create_light(tuple(li["position"]), tuple(li["color"]),
                        li["intensity"],
                        light_type=_LIGHT_TYPES[li.get("type", "point")],
                        direction=tuple(li.get("direction", (0, 0, 0))),
                        cone_angle=li.get("cone_angle", 0.0))

    for inst in spec.get("instances", []):
        sc.create_instance(
            mesh_ids[inst["mesh"]], mat_ids[inst["material"]],
            tuple(inst.get("position", (0, 0, 0))),
            tuple(inst.get("rotation", (0, 0, 0))),
            tuple(inst.get("scale", (1, 1, 1))))

    if "sky" in spec:
        sc.set_sky(**spec["sky"])
    return sc


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
