"""The work the physics asks of one LJ force evaluation, counted from
positions whatever computes it: 8 operations for each ordered pair within
cutforce + skin (the distance test), 15 more for each within cutforce (the
pair term and the sums); each position read once, each force written once.
"""

OPS_LISTED = 8
OPS_INSIDE = 15


def force_ops(pairs) -> float:
    """pairs: ordered pairs within (cutforce + skin, cutforce)."""
    listed, inside = pairs
    return OPS_LISTED * listed + OPS_INSIDE * inside


def force_bytes(natoms: int, precision: str) -> int:
    return 2 * 3 * (8 if precision == "dp" else 4) * natoms


def peak_rate(peaks: dict, precision: str) -> float:
    return peaks["float64" if precision == "dp" else "float32"]


def step_bound_s(pairs, natoms: int, precision: str, peaks: dict) -> float:
    """The least seconds a force evaluation takes on a card with `peaks`."""
    return max(force_ops(pairs) / peak_rate(peaks, precision),
               force_bytes(natoms, precision) / peaks["bytes_per_s"])
