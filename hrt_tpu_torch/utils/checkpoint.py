"""Upscaler parameter checkpoints (hrt_tpu/utils/checkpoint.py).

The JAX package saves its flax parameters with orbax; this package keeps
no flax and no orbax, so a checkpoint is an `.npz` of the flax-keyed
numpy dict (`Conv_i/kernel` HWIO, `Conv_i/bias`): the dict that
utils/interop.upscaler_from_numpy takes and the format of the committed
weights/*.npz.  The frame loop's own state is saved by
FrameLoop.save_state.
"""
from __future__ import annotations

import numpy as np


def save_params(path: str, params: dict) -> None:
    """Write `params` (name -> array) to the `.npz` file `path`, as
    given (no suffix is added)."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str, template: dict | None = None) -> dict:
    """The name -> numpy array dict of an `.npz` checkpoint.  With a
    `template`, the names and shapes must be the template's (ValueError
    otherwise)."""
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    if template is not None:
        if set(params) != set(template):
            raise ValueError(f"{path}: names {sorted(params)} are not the "
                             f"template's {sorted(template)}")
        for k, v in template.items():
            if params[k].shape != np.shape(v):
                raise ValueError(f"{path}: {k} has shape "
                                 f"{params[k].shape}, the template "
                                 f"{np.shape(v)}")
    return params
