"""The comparison that decides `correct`: frames the measured window
produced, against the plain reference (rtbench/reference/), after the
window has closed.

Each checked frame comes with the program's state from just before it
(the accumulation buffer, SVGF's history, the upscaler's HR history)
and the state the program hands on after it, which the frame loop
returns as fresh tensors: the reference takes the state before,
renders the frame itself and runs the post stages, and the numbers say
how far the program's outputs, and its new state, lie from the
reference's.  A program whose state stays as it was, while its output
is right for that state, fails on the new state.

A number is the share of compared pixels whose gap exceeds its `tau`:
gap = |program - reference| / (|reference| + floor), the largest over
the channels (and, for a state of several tensors, over the tensors),
a non-finite gap counting as over.  Under accumulation the gap is that
of the frame's own radiance, (n + 1) times the gap of the running
mean, n the mean's frame count, so that the hundredth frame is judged
as strictly as the first.

- `frame_bad_share`: the frame's radiance at pixels drawn from the
  seed (all of its path: raygen, walks, gather, NEE and K2, bounces,
  roulette, accumulation).
- `accum_bad_share`: the new accumulation buffer at the same pixels.
- `svgf_bad_share`: SVGF's new history, per pixel the worst of its
  colour, luminance moments, history length, depth and normal: the
  whole noisy frame through the temporal accumulation.
- `up_history_bad_share`: the upscaler's new HR history.
- `out_bad_share`: the final HR frame after SVGF and the temporal
  upscaler.

The control (`shade_dtype=torch.bfloat16`, or `up_dtype` float8 for
the upscaler's trunk) is the reference itself computed one precision
lower and put in the program's place.

The reference places the scene once; where the traffic moves
instances (`animate`), each checked frame carries its poses, and the
reference places those instances anew for it.
"""
from __future__ import annotations

import os

import torch

from . import workload
from .reference import pathtrace, post

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hrt_tpu_torch", "weights", "upscaler_temporal.npz")
# Pixels a block of the full-frame reference render.
ROW_BLOCK = 1 << 18


def _rel(prog, ref, scale, floor: float, gain=None):
    gap = (prog - ref).abs().amax(-1)
    if gain is not None:
        gap = gap * gain
    return gap / (scale.abs().amax(-1) + floor)


def bad_share(prog, ref, scale, tau: float, floor: float,
              gain=None) -> tuple[int, int]:
    """(pixels over tau, pixels) of (..., C) outputs; `scale` (..., C)
    sets each pixel's magnitude, `gain` multiplies its gap."""
    rel = _rel(prog, ref, scale, floor, gain)
    return int((~(rel <= tau)).sum()), rel.numel()


def worst_bad_share(pairs, tau: float, floor: float) -> tuple[int, int]:
    """bad_share of a state of several (program, reference) tensors of
    one pixel grid: a pixel is over if any of its tensors is."""
    rel = None
    for prog, ref in pairs:
        r = _rel(prog, ref, ref, floor)
        rel = r if rel is None else torch.maximum(rel, r)
    return int((~(rel <= tau)).sum()), rel.numel()


def _render_full(sc, view, rcfg, frame, device, shade_dtype):
    w, h = rcfg["width"], rcfg["height"]
    idx = torch.arange(w * h, device=device)
    rad, gbs = [], []
    for s in range(0, w * h, ROW_BLOCK):
        i = idx[s:s + ROW_BLOCK]
        r, gb = pathtrace.render_pixels(sc, view, rcfg, i % w, i // w, frame,
                                        shade_dtype, want_gbuffer=True)
        rad.append(r)
        gbs.append(gb)
    img = torch.cat(rad).reshape(h, w, 3)
    gb = {k: torch.cat([g[k] for g in gbs]).reshape(
        (h, w) + gbs[0][k].shape[1:]) for k in gbs[0]}
    return img, gb


class Judge:
    """The reference over one configuration and traffic; `numbers`
    reads a list of checked frames."""

    def __init__(self, scene_arrays, traffic: dict, limits: dict, device):
        self.device = device
        self.scene = scene_arrays
        self.sc = pathtrace.flatten(scene_arrays, device)
        self.rcfg = dict(traffic["render"])
        self.pixels = traffic["check"]["pixels"]
        self.limits = limits["numbers"]
        self.convs = (post.load_upscaler(WEIGHTS, device)
                      if self.rcfg.get("upscale") == 2 else None)

    def _cam(self, view):
        w, h = self.rcfg["width"], self.rcfg["height"]
        return pathtrace.camera(view, w, h, self.device)

    def _placed(self, rec):
        """The reference's scene as the checked frame saw it."""
        if not rec.get("poses"):
            return self.sc
        return pathtrace.flatten(self.scene, self.device, rec["poses"],
                                 base=self.sc)

    def numbers(self, records, seed: int, shade_dtype=None,
                up_dtype=torch.bfloat16) -> dict:
        """{number: share} over the records: the program's outputs
        against the reference's, or, with `shade_dtype` or `up_dtype`
        below the configuration's, the control's."""
        counts: dict = {}
        control = shade_dtype is not None or up_dtype != torch.bfloat16
        for rec in records:
            sc = self._placed(rec)
            if self.pixels == "all":
                got = self._full(sc, rec, shade_dtype, up_dtype, control)
            else:
                got = self._sampled(sc, rec, seed, shade_dtype, control)
            for name, (bad, n) in got.items():
                b0, n0 = counts.get(name, (0, 0))
                counts[name] = (b0 + bad, n0 + n)
        return {k: b / n for k, (b, n) in counts.items()}

    def _lim(self, name):
        lim = self.limits[name]
        return lim["tau"], lim["floor"]

    def _sampled(self, sc, rec, seed, shade_dtype, control) -> dict:
        w, h = self.rcfg["width"], self.rcfg["height"]
        g = workload.rng(seed, 1000 + rec["i"])
        flat = torch.as_tensor(g.choice(w * h, size=min(self.pixels, w * h),
                                        replace=False), device=self.device)
        px, py = flat % w, flat // w
        frame = rec["frame"]
        ref = pathtrace.render_pixels(sc, rec["view"], self.rcfg, px, py,
                                      frame)
        got = (pathtrace.render_pixels(sc, rec["view"], self.rcfg, px, py,
                                       frame, shade_dtype) if control
               else rec["out"].to(self.device)[py, px])
        ref_out, gain = ref, None
        out = {}
        if self.rcfg.get("accumulate"):
            acc = rec["accum"].to(self.device)[py, px]
            ref_out = post.accumulate(acc, ref, frame)
            if control:
                got = post.accumulate(acc, got, frame)
            gain = float(min(frame, 10000) + 1)
            got_acc = (got if control
                       else rec["accum_new"].to(self.device)[py, px])
            tau, floor = self._lim("accum_bad_share")
            out["accum_bad_share"] = bad_share(got_acc, ref_out, ref, tau,
                                               floor, gain)
        tau, floor = self._lim("frame_bad_share")
        out["frame_bad_share"] = bad_share(got, ref_out, ref, tau, floor,
                                           gain)
        return out

    def _full(self, sc, rec, shade_dtype, up_dtype, control) -> dict:
        frame = rec["frame"]
        prev = self._cam(rec["prev_view"])
        state = {"accum": rec["accum"], "up_history": rec["up_history"],
                 "svgf": post.SvgfState(*rec["dn"])}
        img, gb = _render_full(sc, rec["view"], self.rcfg, frame,
                               self.device, None)
        ref_out, ref_new = post.post_frame(img, gb, frame, prev, state,
                                           self.rcfg, self.convs)
        if control:
            img_c = img
            if shade_dtype is not None:
                img_c, _ = _render_full(sc, rec["view"], self.rcfg,
                                        frame, self.device, shade_dtype)
            got_out, got_new = post.post_frame(img_c, gb, frame, prev,
                                               state, self.rcfg, self.convs,
                                               up_dtype)
        else:
            got_out = rec["out"].to(self.device)
            got_new = {"svgf": [t.to(self.device) for t in rec["dn_new"]],
                       "up_history": rec["up_new"].to(self.device)}
        pairs = {
            "out_bad_share": [(got_out, ref_out)],
            "svgf_bad_share": list(zip(got_new["svgf"], ref_new["svgf"])),
            "up_history_bad_share": [(got_new["up_history"],
                                      ref_new["up_history"])]}
        out = {}
        for name, pair in pairs.items():
            tau, floor = self._lim(name)
            out[name] = worst_bad_share(pair, tau, floor)
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {number: {value, limit}})."""
    table = {k: {"value": numbers.get(k), "limit": v["limit"]}
             for k, v in limits["numbers"].items()}
    ok = all(t["value"] is not None and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table
