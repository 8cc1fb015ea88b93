"""VTK trajectory output (the port of ``mdbench_tpu.io.vtk``, the same
files; reference: src/verletlist/vtk.c:12-55).

Same ASCII UNSTRUCTURED_GRID layout: one `<name>_<step>.vtk` file per
timestep with POINTS / CELLS / CELL_TYPES / POINT_DATA sections.
"""

from __future__ import annotations

import numpy as np

from mdbench_tpu_torch.io import native


def write_atoms_to_vtk_file(filename: str, x: np.ndarray, timestep: int) -> str:
    n = x.shape[0]
    path = f"{filename}_{timestep}.vtk"
    # native fast path (byte-identical output; the Python loop costs
    # seconds per frame at the 131k benchmark size)
    if native.write_atoms_vtk(path, np.asarray(x, np.float64)):
        return path
    with open(path, "w") as fp:
        fp.write("# vtk DataFile Version 2.0\n")
        fp.write("Particle data\n")
        fp.write("ASCII\n")
        fp.write("DATASET UNSTRUCTURED_GRID\n")
        fp.write(f"POINTS {n} double\n")
        for i in range(n):
            fp.write("%.4f %.4f %.4f\n" % (x[i, 0], x[i, 1], x[i, 2]))
        fp.write("\n\n")
        fp.write(f"CELLS {n} {n * 2}\n")
        for i in range(n):
            fp.write(f"1 {i}\n")
        fp.write("\n\n")
        fp.write(f"CELL_TYPES {n}\n")
        fp.write("1\n" * n)
        fp.write("\n\n")
        fp.write(f"POINT_DATA {n}\n")
        fp.write("SCALARS mass double\n")
        fp.write("LOOKUP_TABLE default\n")
        fp.write("1.0\n" * n)
        fp.write("\n\n")
    return path


def write_ghost_atoms_to_vtk_file(filename: str, xg: np.ndarray, timestep: int) -> str:
    """Ghost-atom dump (clusterpair reference writes separate ghost files,
    src/clusterpair/vtk.c:14-230); same point format."""
    return write_atoms_to_vtk_file(filename + "_ghost", xg, timestep)


def _write_cluster_edges(path: str, xc, yc, zc, timestep: int) -> str:
    """One VTK LINES cell per cluster connecting its (valid) atoms in
    slot order — the cluster-edge visualization of the reference
    (src/clusterpair/vtk.c: write_local_cluster_edges_to_vtk_file)."""
    nc, m = xc.shape
    valid = np.abs(xc) < 1e29
    pts = []
    lines = []
    for c in range(nc):
        idx = []
        for s in range(m):
            if valid[c, s]:
                idx.append(len(pts))
                pts.append((xc[c, s], yc[c, s], zc[c, s]))
        if len(idx) >= 2:
            lines.append(idx)
    with open(path, "w") as fp:
        fp.write("# vtk DataFile Version 2.0\n")
        fp.write("Cluster edge data\n")
        fp.write("ASCII\n")
        fp.write("DATASET UNSTRUCTURED_GRID\n")
        fp.write(f"POINTS {len(pts)} double\n")
        for p in pts:
            fp.write("%.4f %.4f %.4f\n" % p)
        fp.write("\n\n")
        total = sum(len(ln) + 1 for ln in lines)
        fp.write(f"CELLS {len(lines)} {total}\n")
        for ln in lines:
            fp.write(str(len(ln)) + " " + " ".join(map(str, ln)) + "\n")
        fp.write("\n\n")
        fp.write(f"CELL_TYPES {len(lines)}\n")
        fp.write("4\n" * len(lines))  # VTK_POLY_LINE
        fp.write("\n\n")
    return path


def write_cluster_vtk_files(
    filename: str, clusters, n_clusters_pad: int, nghost16: int,
    timestep: int,
) -> list:
    """The clusterpair reference's 4-file VTK dump (vtk.c:14-230):
    local atoms, ghost atoms, local cluster edges, ghost cluster edges.
    `clusters` is an ops.cluster.Clusters of torch tensors."""
    xc, yc, zc = (t.double().cpu().numpy() for t in (clusters.xc, clusters.yc,
                                                      clusters.zc))
    lv = np.abs(xc[:n_clusters_pad]) < 1e29
    xl = np.stack(
        [xc[:n_clusters_pad][lv], yc[:n_clusters_pad][lv],
         zc[:n_clusters_pad][lv]], axis=1,
    )
    g0, g1 = n_clusters_pad, n_clusters_pad + 2 * nghost16
    gv = np.abs(xc[g0:g1]) < 1e29
    xg = np.stack(
        [xc[g0:g1][gv], yc[g0:g1][gv], zc[g0:g1][gv]], axis=1
    )
    out = [
        write_atoms_to_vtk_file(filename + "_local", xl, timestep),
        write_atoms_to_vtk_file(filename + "_ghost", xg, timestep),
        _write_cluster_edges(
            f"{filename}_local_edges_{timestep}.vtk",
            xc[:n_clusters_pad], yc[:n_clusters_pad], zc[:n_clusters_pad],
            timestep,
        ),
        _write_cluster_edges(
            f"{filename}_ghost_edges_{timestep}.vtk",
            xc[g0:g1], yc[g0:g1], zc[g0:g1], timestep,
        ),
    ]
    return out
