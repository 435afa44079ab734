"""Train-time augmentation (the JAX package's ``data/augmentor.py``): world flips,
a global rotation about z and a global scaling, applied together to the search
points, the template points and the regression label, drawn from the item's
own generator. Valid in LiDAR coordinates only.

The theta channel of ``reg_label`` is in degrees throughout, wrapped to
(-180, 180], as in the JAX package.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..core.geometry import rotate_points_along_z


def _wrap_theta_deg(theta):
    """Wrap a degree-valued theta target to (-180, 180]."""
    return -((-theta + 180.0) % 360.0 - 180.0)


def random_flip_along_x(data_dict, rng):
    if rng.random() < 0.5:
        data_dict["search_points"][:, 1] = -data_dict["search_points"][:, 1]
        data_dict["template_points"][:, 1] = -data_dict["template_points"][:, 1]
        data_dict["reg_label"][1] = -data_dict["reg_label"][1]
        data_dict["reg_label"][-1] = _wrap_theta_deg(-data_dict["reg_label"][-1])
    return data_dict


def random_flip_along_y(data_dict, rng):
    if rng.random() < 0.5:
        data_dict["search_points"][:, 0] = -data_dict["search_points"][:, 0]
        data_dict["template_points"][:, 0] = -data_dict["template_points"][:, 0]
        data_dict["reg_label"][0] = -data_dict["reg_label"][0]
        data_dict["reg_label"][-1] = _wrap_theta_deg(-(data_dict["reg_label"][-1] + 180.0))
    return data_dict


def global_rotation(data_dict, rot_range, rng):
    angle = rng.uniform(rot_range[0], rot_range[1])
    data_dict["search_points"] = rotate_points_along_z(data_dict["search_points"], angle)
    data_dict["template_points"] = rotate_points_along_z(data_dict["template_points"], angle)
    data_dict["reg_label"][0:3] = rotate_points_along_z(data_dict["reg_label"][None, 0:3], angle)[0]
    data_dict["reg_label"][-1] = _wrap_theta_deg(data_dict["reg_label"][-1] + np.degrees(angle))
    return data_dict


def global_scaling(data_dict, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return data_dict
    s = rng.uniform(scale_range[0], scale_range[1])
    data_dict["search_points"][:, :3] *= s
    data_dict["template_points"][:, :3] *= s
    data_dict["reg_label"][:3] *= s
    return data_dict


class DataAugmentor:
    """The queue of DATA_AUGMENTOR's ``AUG_CONFIG_LIST`` (or a list of the same
    entries): ``random_world_flip``, ``random_world_rotation``,
    ``random_world_scaling``."""

    def __init__(self, augmentor_configs):
        cfg_list = augmentor_configs if isinstance(augmentor_configs, list) else augmentor_configs["AUG_CONFIG_LIST"]
        self.queue = []
        for cur in cfg_list:
            name = cur["NAME"]
            if name == "random_world_flip":
                for axis in cur["ALONG_AXIS_LIST"]:
                    if axis not in ("x", "y"):
                        raise ValueError(f"random_world_flip: axis {axis!r} is not x or y")
                    self.queue.append({"x": random_flip_along_x, "y": random_flip_along_y}[axis])
            elif name == "random_world_rotation":
                rot = cur["WORLD_ROT_ANGLE"]
                if not isinstance(rot, list):
                    rot = [-rot, rot]
                self.queue.append(partial(global_rotation, rot_range=rot))
            elif name == "random_world_scaling":
                self.queue.append(partial(global_scaling, scale_range=cur["WORLD_SCALE_RANGE"]))
            else:
                raise NotImplementedError(name)

    def forward(self, data_dict: dict, rng: np.random.Generator) -> dict:
        for fn in self.queue:
            data_dict = fn(data_dict, rng=rng)
        return data_dict
