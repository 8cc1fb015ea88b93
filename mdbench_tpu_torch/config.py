"""Runtime configuration: the `Params` dataclass and the param-file parser.

The PyTorch port's copy of `mdbench_tpu.config`: the same fields,
defaults, parser and banner, so a param file and a `Params(...)` call mean
the same thing in both packages. Only `Params.dtype` differs: it names a
torch dtype.

Mirrors the reference's `Parameter` struct and key-value config files
(reference: src/common/parameter.h:27-61, parameter.c:16-122) with the same
field names and defaults, so existing MD-Bench param files load unchanged.

What the reference fixes at compile time (-D defines from config.mk) is a
runtime axis here:

- ``scheme``       : "verlet" | "cluster"      (reference: OPT_SCHEME)
- ``precision``    : "sp" | "dp"               (reference: DATA_TYPE)
- ``half_neigh``   : runtime in both (reference: param.half_neigh)
- ``compute_stats``: COMPUTE_STATS equivalent (stats are computed
  analytically from the lists rather than per-iteration counters).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

FF_LJ = 0
FF_EAM = 1
FF_DEM = 2


def str2ff(s: str) -> int:
    """Force-field name to id (reference: src/common/util.c:73-78)."""
    s = s.strip().lower()
    if s.startswith("lj"):
        return FF_LJ
    if s.startswith("eam"):
        return FF_EAM
    return -1


def ff2str(ff: int) -> str:
    return {FF_LJ: "lj", FF_EAM: "eam"}.get(ff, "invalid")


@dataclasses.dataclass
class Params:
    """All runtime knobs. Defaults match `initParameter`
    (reference: src/common/parameter.c:16-51)."""

    # Files
    input_file: Optional[str] = None
    vtk_file: Optional[str] = None
    xtc_file: Optional[str] = None
    eam_file: Optional[str] = None
    write_atom_file: Optional[str] = None

    # Physics
    force_field: int = FF_LJ
    epsilon: float = 1.0
    sigma: float = 1.0
    rho: float = 0.8442
    ntypes: int = 1
    mass: float = 1.0
    temp: float = 1.44

    # Box / lattice
    nx: int = 32
    ny: int = 32
    nz: int = 32
    pbc_x: int = 1
    pbc_y: int = 1
    pbc_z: int = 1

    # Integration
    ntimes: int = 200
    dt: float = 0.005

    # Neighboring
    cutforce: float = 2.5
    skin: float = 0.3
    reneigh_every: int = 20
    resort_every: int = 400
    prune_every: int = 1000
    half_neigh: int = 0

    # Output cadence
    nstat: int = 100
    x_out_every: int = 20
    v_out_every: int = 5

    # Reporting
    proc_freq: float = 2.4  # GHz, for cycle-based stats

    # --- Build axes (compile-time in the reference) ---
    # Every field of mdbench_tpu.Params is kept, with its default, so the
    # two packages read the same files and print the same banner. The
    # port runs every setting that mdbench_tpu runs;
    # engine_cluster.check_slice raises NotImplementedError for other
    # schemes and force fields.
    scheme: str = "verlet"  # "verlet" | "cluster"  (port: both, LJ and EAM)
    precision: str = "dp"  # "sp" | "dp"  (reference config.mk DATA_TYPE)
    compute_stats: bool = True
    sort_atoms: bool = True  # reference SORT_ATOMS
    # record T/P every step (True) or only at reneighbor boundaries
    # (False — the reference prints only every nstat steps)
    dense_thermo: bool = True
    # force-kernel axis, as in mdbench_tpu. Cluster scheme: "auto" |
    # "ilist_pl" (the exact-list kernels), "pallas" (the group-window
    # kernel), "ilist" | "xla" (their plain torch twins, on any device).
    # Verlet scheme: "auto" | "rowlist" (16-atom row lists and the
    # exact-list kernels), "xla" (the planar per-atom force). On the CPU
    # every name runs the plain versions
    kernel: str = "auto"
    # FORCE/NEIGH section timing mode of the JAX CLI ("est" | "diff")
    timers: str = "est"
    # i-clusters sharing one exact list: 0 = auto (2)
    ishare: int = 0
    # approximate reciprocal (one Newton step) in the exact-list force
    # kernels K1, K1t and K1b, float32 on the card only, as in
    # mdbench_tpu; the group-window kernels, float64 and the plain
    # versions always divide
    approx_rcp: bool = True
    # EAM per-pair evaluation ("auto" | "spline" | "poly"); the port's
    # cluster EAM evaluates polynomials ("auto" or "poly") and refuses
    # "spline", as mdbench_tpu's cluster EAM does
    eam_eval: str = "auto"
    # bfloat16 distance math in the exact-list derive, with a cutoff
    # inflated by its worst-case error: superset lists
    # (ops/cluster.derive_ilists). The cluster scheme's single engine in
    # SP only, as in mdbench_tpu; DP runs and the other engines ignore it
    derive_bf16: bool = False
    # Tracing/profiling hooks (reference MEM_TRACER / INDEX_TRACER /
    # LIKWID, SURVEY §5.1): output path prefixes; empty = off
    trace_index: str = ""
    trace_mem: str = ""
    profile_dir: str = ""
    # Binary checkpoint/resume (io/checkpoint; exceeds the reference,
    # whose closest facility is the -w restartable .in file, SURVEY
    # §5.4): save final state to checkpoint_file; restore_file resumes
    # a run from a saved state (positions+velocities+types)
    checkpoint_file: str = ""
    restore_file: str = ""

    # Capacity knobs (padded fixed shapes; auto-grown on overflow)
    maxneighs: int = 100  # reference: neighbor.c:59
    atoms_per_bin: int = 8  # reference: neighbor.c:60 (auto-resized)

    # --- Derived (filled by setup()) ---
    lattice: float = 0.0
    xprd: float = 0.0
    yprd: float = 0.0
    zprd: float = 0.0

    def __post_init__(self):
        self.finalize()

    # Derived quantities -------------------------------------------------
    def finalize(self) -> "Params":
        """Recompute derived fields (reference: main.c:233, setup() main.c:42-45,
        readParameter tail parameter.c:115-121)."""
        if self.eam_eval not in ("auto", "spline", "poly"):
            raise ValueError(
                f"eam_eval must be auto|spline|poly, got {self.eam_eval!r}"
            )
        self.cutneigh = self.cutforce + self.skin
        self.dtforce = 0.5 * self.dt
        s2 = self.sigma * self.sigma
        self.sigma6 = s2 * s2 * s2
        self.lattice = (4.0 / self.rho) ** (1.0 / 3.0)
        self.xprd = self.nx * self.lattice
        self.yprd = self.ny * self.lattice
        self.zprd = self.nz * self.lattice
        return self

    @property
    def dtype(self):
        return torch.float64 if self.precision == "dp" else torch.float32

    @property
    def natoms_expected(self) -> int:
        """4 atoms per FCC unit cell (reference: atom.c:75)."""
        return 4 * self.nx * self.ny * self.nz


# Param-file parsing ------------------------------------------------------

_STRING_KEYS = ("input_file", "eam_file", "vtk_file", "xtc_file")
_INT_KEYS = (
    "ntypes", "ntimes", "nx", "ny", "nz", "pbc_x", "pbc_y", "pbc_z",
    "nstat", "reneigh_every", "resort_every", "prune_every",
    "x_out_every", "v_out_every", "half_neigh",
)
_REAL_KEYS = (
    "epsilon", "sigma", "rho", "dt", "cutforce", "skin", "temp", "mass",
    "proc_freq",
)


def read_parameter_file(params: Params, filename: str) -> Params:
    """Parse a `key value # comment` param file into `params`, in place.

    Same grammar and key set as the reference parser
    (src/common/parameter.c:53-122): `#` starts a comment, first token is
    the key, second the value; unknown keys are ignored. The reference
    matches keys by prefix (strncmp); we match exactly, which accepts the
    same well-formed files.
    """
    with open(filename, "r") as fp:
        for raw in fp:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            tok, val = parts[0], parts[1]
            if tok == "force_field":
                ff = str2ff(val)
                if ff >= 0:
                    params.force_field = ff
            elif tok in _STRING_KEYS:
                setattr(params, tok, val)
            elif tok in _INT_KEYS:
                setattr(params, tok, int(val))
            elif tok in _REAL_KEYS:
                setattr(params, tok, float(val))
            # TPU-build extension keys (ignored by the C reference)
            elif tok in ("scheme", "precision", "kernel", "eam_eval"):
                setattr(params, tok, val)
    params.finalize()
    return params


def print_parameters(params: Params) -> str:
    """Render the parameter banner (reference: parameter.c:124-187)."""
    p = params
    lines = ["Parameters:"]
    if p.input_file:
        lines.append(f"\tInput file: {p.input_file}")
    if p.vtk_file:
        lines.append(f"\tVTK file: {p.vtk_file}")
    if p.xtc_file:
        lines.append(f"\tXTC file: {p.xtc_file}")
    if p.eam_file:
        lines.append(f"\tEAM file: {p.eam_file}")
    lines.append(f"\tForce field: {ff2str(p.force_field)}")
    kernel_name = f"{p.scheme} ({p.kernel})"
    lines.append(f"\tKernel: {kernel_name}")
    lines.append("\tData layout: SoA")
    lines.append(
        "\tFloating-point precision: %s"
        % ("double" if p.precision == "dp" else "single")
    )
    lines.append(f"\tUnit cells (nx, ny, nz): {p.nx}, {p.ny}, {p.nz}")
    lines.append(
        "\tDomain box sizes (x, y, z): %e, %e, %e" % (p.xprd, p.yprd, p.zprd)
    )
    lines.append(f"\tPeriodic (x, y, z): {p.pbc_x}, {p.pbc_y}, {p.pbc_z}")
    lines.append("\tLattice size: %e" % p.lattice)
    lines.append("\tEpsilon: %e" % p.epsilon)
    lines.append("\tSigma: %e" % p.sigma)
    lines.append("\tTemperature: %e" % p.temp)
    lines.append("\tRHO: %e" % p.rho)
    lines.append("\tMass: %e" % p.mass)
    lines.append(f"\tNumber of types: {p.ntypes}")
    lines.append(f"\tNumber of timesteps: {p.ntimes}")
    lines.append(f"\tReport stats every (timesteps): {p.nstat}")
    lines.append(f"\tReneighbor every (timesteps): {p.reneigh_every}")
    if p.sort_atoms:
        lines.append(f"\tResort atoms every (timesteps): {p.resort_every}")
    else:
        lines.append("\tSort atoms: no")
    lines.append(f"\tPrune every (timesteps): {p.prune_every}")
    lines.append(f"\tOutput positions every (timesteps): {p.x_out_every}")
    lines.append(f"\tOutput velocities every (timesteps): {p.v_out_every}")
    lines.append("\tDelta time (dt): %e" % p.dt)
    lines.append("\tCutoff radius: %e" % p.cutforce)
    lines.append("\tSkin: %e" % p.skin)
    lines.append(f"\tHalf neighbor lists: {p.half_neigh}")
    lines.append("\tProcessor frequency (GHz): %.4f" % p.proc_freq)
    return "\n".join(lines)
