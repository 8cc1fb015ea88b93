"""Thermodynamics set-up (reference: src/common/thermo.c): unit scales and
the initial velocity adjustment, host-side numpy in float64 as in
``mdbench_tpu.thermo``. The per-step temperature/pressure readout is a
torch reduction in ``engine_cluster.ClusterSimulation._thermo``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mdbench_tpu_torch.config import FF_EAM, FF_LJ, Params


class ThermoScales(NamedTuple):
    mvv2e: float
    dof_boltz: float
    t_scale: float
    p_scale: float
    e_scale: float


def setup_thermo(params: Params, natoms: int) -> ThermoScales:
    """Unit scale factors (reference: thermo.c:30-53).

    NOTE: for EAM the reference also divides param->dtforce by mvv2e
    (thermo.c:51); callers must apply `adjusted_dtforce`.
    """
    if params.force_field == FF_LJ:
        mvv2e = 1.0
        dof_boltz = float(natoms * 3 - 3)
        t_scale = mvv2e / dof_boltz
        p_scale = 1.0 / 3 / params.xprd / params.yprd / params.zprd
        e_scale = 0.5
    elif params.force_field == FF_EAM:
        mvv2e = 1.036427e-04
        dof_boltz = (natoms * 3 - 3) * 8.617343e-05
        t_scale = mvv2e / dof_boltz
        p_scale = 1.602176e06 / 3 / params.xprd / params.yprd / params.zprd
        e_scale = 524287.985533
    else:
        raise ValueError(f"unknown force field {params.force_field}")
    return ThermoScales(mvv2e, dof_boltz, t_scale, p_scale, e_scale)


def adjusted_dtforce(params: Params, scales: ThermoScales) -> float:
    """dtforce after the EAM unit correction (reference: thermo.c:51)."""
    if params.force_field == FF_EAM:
        return params.dtforce / scales.mvv2e
    return params.dtforce


def adjust_thermo(params: Params, scales: ThermoScales, v: np.ndarray, natoms: int):
    """Zero center-of-mass momentum, then rescale to the target temperature
    (reference: thermo.c:82-122). Host-side, float64, returns new v.
    """
    v = np.asarray(v, np.float64).copy()
    vtot = v.sum(axis=0) / natoms  # reference divides by Natoms, not Nlocal
    v -= vtot
    t = (v * v).sum() * params.mass * scales.t_scale
    factor = np.sqrt(params.temp / t)
    v *= factor
    return v
