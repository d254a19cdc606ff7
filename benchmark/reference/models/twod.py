"""twod: upstream cyclistsocialforce's `TwoDBicycle`, the BMD2023 "2D
model": bicycle2d's P-controlled kinematics (`bicycle2d`) with the
arrived-freeze (once the FSM has latched "arrived", speed, steer and roll
are zero and control is skipped, its memory held). Its spline destination
force (`..dest_spline`) reads the position ring."""

import torch

from . import bicycle2d

EXTRA_FIELDS = ("pos_hist", "t_glob")


def constants(cfg: dict, dtype, device) -> dict:
    return {}


def initial(st: dict, c: dict) -> dict:
    return {}


def step(st: dict, c: dict, fx, fy) -> dict:
    out = bicycle2d.step(st, c, fx, fy)
    arrived = st["znav"][:, 2:3]
    frozen = st["s"].clone()
    frozen[:, 3:6] = 0.0                     # speed, steer, roll
    return {"s": torch.where(arrived, frozen, out["s"]),
            "pid_e": torch.where(arrived, st["pid_e"], out["pid_e"])}
