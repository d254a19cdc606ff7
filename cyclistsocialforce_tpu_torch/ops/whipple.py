"""Linearized Whipple-Carvallo bicycle model (Meijaard et al. 2007).

Counterpart of `cyclistsocialforce_tpu.ops.whipple`: the canonical
benchmark matrices M, C1, K0, K2 from the 27 physical parameters (numpy,
built once on the host), and the 4- and 5-state state-space forms at a
speed v (torch, float64 unless `v` is a tensor of another dtype).
Equations of motion M qdd + v C1 qd + (g K0 + v^2 K2) q = f with
q = [phi (roll), delta (steer)] and f = [T_phi, T_delta], from

    Meijaard, Papadopoulos, Ruina & Schwab (2007), "Linearized dynamics
    equations for the balance and steer of a bicycle: a benchmark and
    review", Proc. R. Soc. A 463:1955-1982 (Appendix A),

checked against the paper's Table 2 in tests/test_torch_whipple.py.
"""

from __future__ import annotations

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.ops.smallmat import matmul_small

# The Meijaard-2007 parameter set shipped with the reference
# (reference data/bicycleparams/balanceassist_bikeparams.py:11-40, derived
# from Moore's BicycleParameters "Balanceassistv1" + average rider, BSD-2).
BALANCEASSIST_WITH_RIDER = dict(
    IBxx=16.136560964517308, IBxz=-2.5375819134691833, IByy=18.98228436804581,
    IBzz=4.308368614306412, IFxx=0.0995, IFyy=0.1902, IHxx=0.2984,
    IHxz=-0.038, IHyy=0.257, IHzz=0.0566, IRxx=0.1023, IRyy=0.1887,
    c=0.042, g=9.81, lam=0.255, mB=91.50000000000003, mF=2.235, mH=4.3,
    mR=4.085, rF=0.35231, rR=0.34895, v=1.0, w=1.113,
    xB=0.373106714751133, xH=0.921, yB=0.0, zB=-0.9697039390081493,
    zH=-0.86,
)

# Benchmark bicycle of Meijaard et al. (2007) Table 1: the independent
# test anchor (its canonical matrices are published).
MEIJAARD_BENCHMARK = dict(
    w=1.02, c=0.08, lam=np.pi / 10, g=9.81, v=1.0,
    rR=0.3, mR=2.0, IRxx=0.0603, IRyy=0.12,
    xB=0.3, zB=-0.9, mB=85.0, IBxx=9.2, IBxz=2.4, IByy=11.0, IBzz=2.8,
    xH=0.9, zH=-0.7, mH=4.0, IHxx=0.05892, IHxz=-0.00756, IHyy=0.06,
    IHzz=0.00708,
    rF=0.35, mF=3.0, IFxx=0.1405, IFyy=0.28,
)


def canonical_matrices(p: dict):
    """Physical parameters -> (M, C1, K0, K2) as [2, 2] numpy arrays,
    Meijaard 2007 Appendix A."""
    w, c, lam, g = p["w"], p["c"], p["lam"], p["g"]
    rR, mR, IRxx, IRyy = p["rR"], p["mR"], p["IRxx"], p["IRyy"]
    xB, zB, mB = p["xB"], p["zB"], p["mB"]
    IBxx, IBxz, IBzz = p["IBxx"], p["IBxz"], p["IBzz"]
    xH, zH, mH = p["xH"], p["zH"], p["mH"]
    IHxx, IHxz, IHzz = p["IHxx"], p["IHxz"], p["IHzz"]
    rF, mF, IFxx, IFyy = p["rF"], p["mF"], p["IFxx"], p["IFyy"]

    cl, sl = np.cos(lam), np.sin(lam)

    # total system
    mT = mR + mB + mH + mF
    xT = (xB * mB + xH * mH + w * mF) / mT
    zT = (-rR * mR + zB * mB + zH * mH - rF * mF) / mT
    ITxx = (IRxx + IBxx + IHxx + IFxx + mR * rR**2 + mB * zB**2
            + mH * zH**2 + mF * rF**2)
    ITxz = (IBxz + IHxz - mB * xB * zB - mH * xH * zH + mF * w * rF)
    IRzz, IFzz = IRxx, IFxx
    ITzz = (IRzz + IBzz + IHzz + IFzz + mB * xB**2 + mH * xH**2 + mF * w**2)

    # front assembly (handlebar + fork + front wheel)
    mA = mH + mF
    xA = (xH * mH + w * mF) / mA
    zA = (zH * mH - rF * mF) / mA
    IAxx = IHxx + IFxx + mH * (zH - zA)**2 + mF * (rF + zA)**2
    IAxz = (IHxz - mH * (xH - xA) * (zH - zA) + mF * (w - xA) * (rF + zA))
    IAzz = IHzz + IFzz + mH * (xH - xA)**2 + mF * (w - xA)**2

    # steer-axis quantities
    uA = (xA - w - c) * cl - zA * sl
    IAll = mA * uA**2 + IAxx * sl**2 + 2 * IAxz * sl * cl + IAzz * cl**2
    IAlx = -mA * uA * zA + IAxx * sl + IAxz * cl
    IAlz = mA * uA * xA + IAxz * sl + IAzz * cl

    mu = c / w * cl

    SR = IRyy / rR
    SF = IFyy / rF
    ST = SR + SF
    SA = mA * uA + mu * mT * xT

    M = np.array([
        [ITxx, IAlx + mu * ITxz],
        [IAlx + mu * ITxz, IAll + 2 * mu * IAlz + mu**2 * ITzz],
    ])
    K0 = np.array([
        [mT * zT, -SA],
        [-SA, -SA * sl],
    ])
    K2 = np.array([
        [0.0, (ST - mT * zT) / w * cl],
        [0.0, (SA + SF * sl) / w * cl],
    ])
    C1 = np.array([
        [0.0, mu * ST + SF * cl + ITxz / w * cl - mu * mT * zT],
        [-(mu * ST + SF * cl), IAlz / w * cl + mu * (SA + ITzz / w * cl)],
    ])
    return M, C1, K0, K2


def _speed(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float64)


def state_space_4(p: dict, v):
    """4-state Whipple model x = [phi, delta, phidot, deltadot],
    u = [T_phi, T_delta]: (A [..., 4, 4], B [..., 4, 2]) at speeds v (a
    number or a [...] tensor). Matches
    `bicycleparameters.models.Meijaard2007Model.form_state_space_matrices`
    as the reference consumes it (dynamics.py:522, parameters.py:1325-1341).
    """
    v = _speed(v)
    M, C1, K0, K2 = canonical_matrices(p)
    Minv = np.linalg.inv(M)

    def t(a):
        return torch.as_tensor(a, dtype=v.dtype, device=v.device)

    vv = v[..., None, None]
    stiff = p["g"] * t(K0) + vv**2 * t(K2)                  # [..., 2, 2]
    A = torch.zeros(v.shape + (4, 4), dtype=v.dtype, device=v.device)
    A[..., 0:2, 2:4] = torch.eye(2, dtype=v.dtype, device=v.device)
    A[..., 2:4, 0:2] = -matmul_small(t(Minv), stiff)
    A[..., 2:4, 2:4] = t(-Minv @ C1) * vv
    B = torch.zeros(v.shape + (4, 2), dtype=v.dtype, device=v.device)
    B[..., 2:4, :] = t(Minv)
    return A, B


def state_space_5(p: dict, v):
    """5-state model with yaw, x = [phi, delta, phidot, deltadot, psi]:
    (A [..., 5, 5], B [..., 5, 1], C [1, 5]). Adds the kinematic yaw row
    psi_dot = (v cos(lam)/w) delta + (c cos(lam)/w) delta_dot
    (reference dynamics.py:296-302, 511-538); the input is the steer
    torque column alone (dynamics.py:470, 612-613)."""
    v = _speed(v)
    A4, B4 = state_space_4(p, v)
    cl = np.cos(p["lam"])
    w, c = p["w"], p["c"]
    A = torch.zeros(v.shape + (5, 5), dtype=v.dtype, device=v.device)
    A[..., :4, :4] = A4
    A[..., 4, 1] = cl / w * v
    A[..., 4, 3] = cl * c / w
    B = torch.zeros(v.shape + (5, 1), dtype=v.dtype, device=v.device)
    B[..., :4, 0] = B4[..., :, 1]
    C = torch.zeros((1, 5), dtype=v.dtype, device=v.device)
    C[0, 4] = 1.0
    return A, B, C
