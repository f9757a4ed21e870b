"""The frames a run asks for, from its traffic file and its seed: the
camera of every frame (still, or on an orbit), the first frame index,
and the poses of the instances that move.  One general generator; a
traffic mix is data.

A traffic file holds `render` (the RenderConfig fields of the frame),
`camera` (`{"path": "still"}`, or `{"path": "orbit",
"frames_per_orbit": k}`), `frame0_from_seed` (the seed picks the first
frame index, which seeds the frame's samples, in [0, that)), and
`check` (how many frames the comparison takes, and how many pixels of
each or "all").  The configuration file gives the scene's views:
`views.still` (position, rotation, fov_y) and `views.orbit` (radius,
height, target, fov_y).

An optional `animate` block moves instances every frame:
`{"instances": k, "period": p, "lift": h, "spin": s}`, and optionally
`"near": [x, y, z]`.  The movers are the k grid instances
(`instance_grids`) nearest that point, by default the orbit's target,
which the camera looks at: a mover out of view would move nothing that
the comparison sees.  They depend on the configuration and the traffic
alone, so every frame of every run poses the same instances.  The seed
gives each a phase, on a stream of its own.  At frame i an instance's
angle is a = 2 pi ((i mod p) / p + phase); it rises h (1 - cos a) / 2
above where the configuration puts it (-y is up) and turns s a about
y, s whole turns a period.
"""
from __future__ import annotations

import math

import numpy as np

from . import geometry

DEFAULT_FOV = 1.0471975512


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator of the seed (any whole number) and a stream number."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def orbit_view(t: float, radius: float, height: float, target,
               fov_y: float = DEFAULT_FOV) -> dict:
    """The camera circling `target` at `radius`, `height` above it in
    the y-down world, looking at it, at angle t."""
    px = target[0] + radius * math.sin(t)
    pz = target[2] - radius * math.cos(t)
    yaw = math.atan2(target[0] - px, target[2] - pz)
    dist = math.sqrt((target[0] - px) ** 2 + (target[2] - pz) ** 2)
    pitch = -math.atan2(target[1] - height, dist)
    return {"position": (px, height, pz), "rotation": (pitch, yaw, 0.0),
            "fov_y": fov_y}


def movers(animate: dict, config: dict, insts: list) -> list:
    """The instances an `animate` block moves: the `instances` grid
    instances nearest `near` (default the orbit's target), the nearer
    first and, at equal distance, the lower index."""
    first, k = len(config["instances"]), int(animate["instances"])
    if not (0 < k <= len(insts) - first
            and float(animate["spin"]).is_integer()):
        raise ValueError(f"animate {animate}: 1 to {len(insts) - first} "
                         f"grid instances, whole turns")
    near = animate.get("near")
    if near is None:
        if "orbit" not in config.get("views", {}):
            raise ValueError("animate needs `near` where the configuration "
                             "has no orbit view")
        near = config["views"]["orbit"]["target"]
    pos = np.array([inst["position"] for inst in insts[first:]], np.float64)
    d2 = ((pos - np.asarray(near, np.float64)) ** 2).sum(1)
    return (first + np.argsort(d2, kind="stable")[:k]).tolist()


class Plan:
    """Frame i of a run: its camera (`view(i)`), its frame index
    (`frame0 + i`) and its instance poses (`poses(i)`)."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        cam = traffic["camera"]
        self.path = cam["path"]
        g = rng(seed, 1)
        self.frame0 = (int(g.integers(traffic["frame0_from_seed"]))
                       if traffic.get("frame0_from_seed") else 0)
        if self.path == "still":
            v = config["views"]["still"]
            self._still = {"position": tuple(v["position"]),
                           "rotation": tuple(v["rotation"]),
                           "fov_y": v.get("fov_y", DEFAULT_FOV)}
        elif self.path == "orbit":
            self.orbit = dict(config["views"]["orbit"])
            self.period = int(cam["frames_per_orbit"])
            self.phase = int(g.integers(self.period))
        else:
            raise ValueError(f"unknown camera path {self.path!r}")
        self.animate = traffic.get("animate")
        self.moving = {}
        if self.animate:
            insts = geometry.instance_list(config)
            pick = movers(self.animate, config, insts)
            phase = rng(seed, 3).random(len(pick))
            for idx, ph in zip(pick, phase.tolist()):
                inst = insts[idx]
                self.moving[idx] = (tuple(inst["position"]),
                                    tuple(inst["rotation"]),
                                    tuple(inst["scale"]), ph)

    def view(self, i: int) -> dict:
        if self.path == "still":
            return self._still
        o = self.orbit
        t = 2.0 * math.pi * ((self.phase + i) % self.period) / self.period
        return orbit_view(t, o["radius"], o["height"], tuple(o["target"]),
                          o.get("fov_y", DEFAULT_FOV))

    def poses(self, i: int) -> dict:
        """{instance: (position, rotation, scale)} of the instances that
        move, at frame i; {} where nothing moves."""
        if not self.moving:
            return {}
        a = self.animate
        p = int(a["period"])
        out = {}
        for idx, (pos, rot, scale, ph) in self.moving.items():
            ang = 2.0 * math.pi * (((i % p) / p + ph) % 1.0)
            up = a["lift"] * 0.5 * (1.0 - math.cos(ang))
            out[idx] = ((pos[0], pos[1] - up, pos[2]),
                        (rot[0], rot[1] + a["spin"] * ang, rot[2]), scale)
        return out
