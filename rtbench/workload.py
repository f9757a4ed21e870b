"""The frames a run asks for, from its traffic file and its seed: the
camera of every frame (still, or on an orbit) and the first frame
index.  One general generator; a traffic mix is data.

A traffic file holds `render` (the RenderConfig fields of the frame),
`camera` (`{"path": "still"}`, or `{"path": "orbit",
"frames_per_orbit": k}`), `frame0_from_seed` (the seed picks the first
frame index, which seeds the frame's samples, in [0, that)), and
`check` (how many frames the comparison takes, and how many pixels of
each or "all").  The configuration file gives the scene's views:
`views.still` (position, rotation, fov_y) and `views.orbit` (radius,
height, target, fov_y).
"""
from __future__ import annotations

import math

import numpy as np

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


class Plan:
    """Frame i of a run: its camera (`view(i)`) and its frame index
    (`frame0 + i`)."""

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

    def view(self, i: int) -> dict:
        if self.path == "still":
            return self._still
        o = self.orbit
        t = 2.0 * math.pi * ((self.phase + i) % self.period) / self.period
        return orbit_view(t, o["radius"], o["height"], tuple(o["target"]),
                          o.get("fov_y", DEFAULT_FOV))
