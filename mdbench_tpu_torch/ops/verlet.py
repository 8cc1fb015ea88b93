"""Verlet neighbour lists and the row-list LJ force in torch ops (the port
of ``mdbench_tpu.ops.verlet``; reference src/verletlist/neighbor.c:186-264
buildNeighbor, force_lj-x86.c:21-112 for the row lists' role).

Two list forms:

- per-atom lists (`build_neighbors`): per local atom, every row of x in
  the 27-bin stencil within cutneigh, ascending, padded with the sentinel
  row (the last row of x); half lists keep j > i only;
- row lists of the rowlist path: per unit of 16 consecutive local atoms,
  the ids of the 16-atom rows of x (in atom order) that hold an atom
  within cutneigh of an atom of the unit, ascending, padded with the id of
  the last, all-sentinel row. `derive_rowlists` is the union of the
  per-atom lists (the oracle), `derive_rowlists_from_cells` builds them
  from the cell table, and `derive_rowlists_from_ranges` (the engine's
  default, with sorted atoms) from contiguous row ranges of bin-sorted
  locals and cell-sorted ghosts. All three give the same rows in the same
  order, mdbench_tpu's, with the same overflow flags and observed maxima
  (`stats`), so the engine's capacities and bucket plans are the same.

`compute_force_lj_rowlist` takes the row lists to the exact-list LJ force
of ``ops/lj_cluster.py`` with share 2 (a 16-atom row plays the cluster
scheme's j16): on a CUDA tensor the K1 kernel, or its bucketed form K1b
when the lists carry bucket maps; on a CPU tensor their plain twins.
The exact prune both row-list builds end with (`_exact_prune`) is, on a
CUDA tensor, one launch of ``csrc/verlet_prune.cu`` (no distance leaves
the registers), and on a CPU tensor its plain version `exact_prune_ref`:
the same rows and counts, bit for bit. The ranges build's candidate
stage before it (`_range_candidates`) is, on a CUDA tensor, one launch
of ``csrc/verlet_ranges.cu`` after the bins and start tables, and on a
CPU tensor its plain version `range_candidates_ref`.

Large intermediates are built in chunks of units (or atoms) whose size
only bounds memory: every sort and selection works within a row, so the
result does not depend on it. mdbench_tpu's sort compactions (a packed
key ranking first occurrences before the rest) become one torch.sort on
the same unique key. Nothing synchronises with the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench_tpu_torch import _build
from mdbench_tpu_torch.ops.cells import (
    CellGrid,
    CellList,
    bin_coords,
    column_offsets,
    coord_to_bin,
    flat_bin,
    np_dtype,
    stencil_bins,
)
from mdbench_tpu_torch.ops.lj_cluster import (
    lj_cluster_force_buckets,
    lj_cluster_force_ilist,
)
from mdbench_tpu_torch.state import NeighborList
from mdbench_tpu_torch.tracing import region

FBIG = 1e30  # bbox fill of empty slots (mdbench_tpu's fbig)
COL_BIG = 1 << 29  # "no column" (mdbench_tpu's big in the unit columns)
RBIG = 1 << 28  # empty row range (sorts last)
MAX_ELEMS = 1 << 25  # elements of one chunk's largest intermediate
# kernel launches made by _exact_prune (a run's proof that the prune went
# through csrc/verlet_prune.cu); callers may reset it to 0
PRUNE_LAUNCHES = 0
# kernel launches made by _range_candidates (the proof that a ranges build
# went through csrc/verlet_ranges.cu); callers may reset it to 0
RANGES_LAUNCHES = 0


def _chunks(n: int, per_item: int, max_elems: int | None = None):
    """Slices of range(n) whose items times per_item stay under max_elems
    (None: the module's MAX_ELEMS as it is at the call, so that setting
    it reaches every build)."""
    if max_elems is None:
        max_elems = MAX_ELEMS
    step = max(1, max_elems // max(per_item, 1))
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def _first_mask(s: torch.Tensor, fill) -> torch.Tensor:
    """First occurrence of each value in the sorted rows of s, not `fill`."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return first & (s != fill)


def _compact(keep: torch.Tensor, vals: torch.Tensor, width: int, fill):
    """The kept entries of each row first, in row order, then `fill`; the
    first `width` columns (padded with fill past the row's length)."""
    n = keep.shape[1]
    pos = torch.arange(n, device=keep.device)
    key, order = torch.sort(torch.where(keep, pos, n + pos), dim=1)
    out = torch.where(key < n, torch.gather(vals, 1, order), fill)
    return _cols(out, width, fill)


def _cols(t: torch.Tensor, width: int, fill):
    if t.shape[1] >= width:
        return t[:, :width]
    return torch.nn.functional.pad(t, (0, width - t.shape[1]), value=fill)


def build_neighbors(grid: CellGrid, cl: CellList, x, types, cutneighsq,
                    nlocal: int, nlocal_pad: int, maxneighs: int,
                    half: bool) -> NeighborList:
    """Per-atom verlet lists (reference buildNeighbor): per local atom the
    rows of the 27-bin stencil with rsq <= cutneighsq (a scalar, or a
    (T, T) table indexed by the types of i and j), not itself, not the
    sentinel row, and with `half` only j > i; ascending, the first
    maxneighs kept, the rest the sentinel row. Overflow: a list longer
    than maxneighs, or the cell table's."""
    nrows = x.shape[0]
    dev = x.device
    sentinel_row = nrows - 1
    typed = torch.is_tensor(cutneighsq) and cutneighsq.dim() == 2
    d = grid.dims
    safe_bin = (1 * d[1] + 1) * d[2] + 1  # an interior bin for padded rows
    cells = cl.cells
    cap = cells.shape[1]
    planes = [x[:, k][cells] for k in range(3)]  # (nbins + 1, cap) each
    C = 27 * cap
    neighs, nns = [], []
    for sl in _chunks(nlocal_pad, C * 8):
        i_idx = torch.arange(sl.start, sl.stop, device=dev)
        n = i_idx.shape[0]
        is_real = i_idx < nlocal
        i_safe = torch.where(is_real, i_idx, 0)
        ib = torch.where(is_real, cl.bin_of[i_safe], safe_bin)
        cand_bins = stencil_bins(grid, ib)  # (n, 27)
        cand = cells[cand_bins].reshape(n, C)
        xi = x[i_safe]
        rsq = None
        for k in range(3):
            dk = xi[:, k, None] - planes[k][cand_bins].reshape(n, C)
            rsq = dk * dk if rsq is None else rsq + dk * dk
        if typed:
            nt = cutneighsq.shape[0]
            cut = cutneighsq.reshape(-1)[types[i_safe].long()[:, None] * nt
                                         + types[cand].long()]
        else:
            cut = cutneighsq
        mask = (rsq <= cut) & (cand != i_idx[:, None]) & is_real[:, None]
        mask &= cand != sentinel_row
        if half:
            mask &= cand > i_idx[:, None]
        nns.append(mask.sum(1))
        packed = torch.sort(torch.where(mask, cand, sentinel_row), dim=1).values
        neighs.append(_cols(packed, maxneighs, sentinel_row))
    neighbors = torch.cat(neighs)
    numneigh = torch.cat(nns)
    overflow = (numneigh > maxneighs).any() | cl.overflow
    return NeighborList(neighbors=neighbors, numneigh=numneigh, overflow=overflow)


def derive_rowlists(nlist: NeighborList, nlocal_pad: int, nrows: int, rcap: int):
    """Row lists as the union of the per-atom lists (the oracle): unit u's
    rows are the distinct j // 16 of its atoms' lists, plus u itself.
    Returns (rows (nu, rcap) int32, numrows (nu,) int32, overflow)."""
    neighbors, numneigh = nlist.neighbors, nlist.numneigh
    K = neighbors.shape[1]
    if nrows % 16 or nlocal_pad % 16 or rcap % 8:
        raise ValueError("nrows and nlocal_pad must be multiples of 16, rcap of 8")
    dev = neighbors.device
    nu = nlocal_pad // 16
    sent16 = nrows // 16 - 1
    W = 16 * (K + 1)
    lane = torch.arange(K, device=dev)[None, :]
    own = (torch.arange(nlocal_pad, device=dev) // 16)[:, None]
    rows_all = torch.where(lane < numneigh[:, None], neighbors // 16, sent16)
    rows_all = torch.cat([rows_all, own], dim=1).reshape(nu, W)
    rows, cnts = [], []
    for sl in _chunks(nu, W * 4):
        s = torch.sort(rows_all[sl], dim=1).values
        first = _first_mask(s, sent16)
        cnts.append(first.sum(1))
        rows.append(_compact(first, s, rcap, sent16))
    numrows = torch.cat(cnts).to(torch.int32)
    return (torch.cat(rows).to(torch.int32).contiguous(), numrows,
            (numrows > rcap).any())


def _unit_columns(grid: CellGrid, x, nlocal: int, nlocal_pad: int, ucol: int):
    """Per 16-atom unit, its distinct xy columns (ascending) with each
    column's own z-cell range over the unit's atoms: (dcol, dzlo, dzhi)
    (nu, ucol), COL_BIG / 0 where absent; n_dc (nu,) the distinct count;
    czspan (nu, 16) each first slot's z span; validu (nu, 16)."""
    dev = x.device
    nu = nlocal_pad // 16
    d2 = grid.dims[2]
    b3 = bin_coords(grid, x[:nlocal_pad])
    validu = (torch.arange(nlocal_pad, device=dev) < nlocal).reshape(nu, 16)
    flat16 = torch.where(validu, flat_bin(grid, b3).reshape(nu, 16), COL_BIG)
    fs = torch.sort(flat16, dim=1).values  # (col, z) packed ascending
    colS = torch.where(fs < COL_BIG, fs // d2, COL_BIG)
    zS = torch.where(fs < COL_BIG, fs % d2, 0)
    zmax_run = zS  # each column run's last z, propagated backward
    for k in (1, 2, 4, 8):
        colSh = torch.nn.functional.pad(colS[:, k:], (0, k), value=COL_BIG)
        zmh = torch.nn.functional.pad(zmax_run[:, k:], (0, k), value=0)
        zmax_run = torch.where(colSh == colS, torch.maximum(zmax_run, zmh), zmax_run)
    firstu = _first_mask(colS, COL_BIG)
    n_dc = firstu.sum(1)
    czspan = torch.where(firstu, zmax_run - zS, 0)
    p16 = torch.arange(16, device=dev)[None, :]
    _, order = torch.sort(torch.where(firstu, p16, 16 + p16), dim=1)
    live = _cols(torch.gather(firstu, 1, order), ucol, False)
    dcol = torch.where(live, _cols(torch.gather(colS, 1, order), ucol, COL_BIG), COL_BIG)
    dzlo = torch.where(live, _cols(torch.gather(zS, 1, order), ucol, 0), 0)
    dzhi = torch.where(live, _cols(torch.gather(zmax_run, 1, order), ucol, 0), 0)
    return dcol, dzlo, dzhi, n_dc, czspan, validu


def _unit_bounds(p16, validu):
    """(lo, hi) per unit over its real atoms (FBIG / -FBIG if none)."""
    return (torch.where(validu, p16, FBIG).amin(1),
            torch.where(validu, p16, -FBIG).amax(1))


def exact_prune_ref(x, cand, nlocal_pad: int, validu, cutsq: float, rcap: int,
                    sent16: int):
    """The plain version of `_exact_prune`, in torch ops on any device:
    per chunk of units a (units, 16, cc x 16) block of squared distances,
    the padding i-atoms at FBIG, the minimum over it (NaN if any is NaN),
    then a sort compaction. Returns (rows (nu, rcap) in cand's dtype,
    numrows (nu,) int64)."""
    nu, cc = cand.shape
    planes = [x[:, k].reshape(-1, 16) for k in range(3)]
    units = [x[:nlocal_pad, k].reshape(nu, 16) for k in range(3)]
    outs, nrs = [], []
    for sl in _chunks(nu, 16 * cc * 16 * 2):
        cu = cand[sl]
        n = cu.shape[0]
        rsq = None
        for pj, pi in zip(planes, units):
            dk = pi[sl][:, :, None] - pj[cu].reshape(n, 1, cc * 16)
            rsq = dk * dk if rsq is None else rsq + dk * dk
        # padding i-atoms: a padding atom and a padding slot of a row
        # both sit at SENTINEL_COORD, so their raw rsq is 0
        rsq = torch.where(validu[sl][:, :, None], rsq, FBIG)
        mind = rsq.amin(1).reshape(n, cc, 16).amin(2)
        keep = (mind <= cutsq) & (cu != sent16)
        nrs.append(keep.sum(1))
        outs.append(_compact(keep, cu, rcap, sent16))
    return torch.cat(outs), torch.cat(nrs)


def _check_prune_args(x, cand, nlocal_pad: int, validu, rcap: int, sent16: int):
    """The operands the prune kernel takes (raises on any other): x
    (nrows, 3) float32 or float64, contiguous and 16-byte aligned, nrows a
    multiple of 16 and at least nlocal_pad; cand (nlocal_pad / 16, cc)
    int64 and validu (nlocal_pad / 16, 16) bool, contiguous, on x's
    device; sent16 a 16-row id of x; sizes within int32."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if cand.dtype != torch.int64:
        raise TypeError(f"cand must be int64, got {cand.dtype}")
    if validu.dtype != torch.bool:
        raise TypeError(f"validu must be bool, got {validu.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or x.shape[0] % 16:
        raise ValueError(f"x must be (nrows, 3) with nrows a multiple of 16, got "
                         f"{tuple(x.shape)}")
    nu = nlocal_pad // 16
    if (nlocal_pad % 16 or nlocal_pad > x.shape[0] or cand.dim() != 2
            or cand.shape[0] != nu or tuple(validu.shape) != (nu, 16)):
        raise ValueError(f"cand {tuple(cand.shape)} and validu {tuple(validu.shape)} "
                         f"must have nlocal_pad / 16 = {nlocal_pad / 16} units of x's "
                         f"{x.shape[0]} rows")
    if not (x.is_contiguous() and cand.is_contiguous() and validu.is_contiguous()):
        raise ValueError("x, cand and validu must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if cand.device != x.device or validu.device != x.device:
        raise ValueError("x, cand and validu must be on one device")
    if not 0 <= sent16 < x.shape[0] // 16:
        raise ValueError(f"sent16 {sent16} is not a 16-row id of x")
    if max(x.shape[0] // 16, cand.shape[1], rcap) >= 2**31 or rcap < 0:
        raise ValueError("sizes must fit in int32 and rcap be >= 0")


def _exact_prune(x, cand, nlocal_pad: int, validu, cutsq: float, rcap: int,
                 sent16: int):
    """Keep a candidate row iff some (unit atom, row atom) pair is within
    cutneigh (the stage mdbench_tpu's two row-list builds share); kept
    rows in candidate order. Returns (rows (nu, rcap) in cand's dtype,
    numrows (nu,) int64), built inside one "reneighbor.prune" span: on a
    CPU tensor by `exact_prune_ref`, on a CUDA tensor by one launch of
    ``csrc/verlet_prune.cu`` on the current stream (the same bits; built
    from csrc/ at first use; the operands are checked first and a launch
    error raises). Any other device raises."""
    global PRUNE_LAUNCHES
    with region("reneighbor.prune"):
        if x.device.type == "cpu":
            return exact_prune_ref(x, cand, nlocal_pad, validu, cutsq, rcap, sent16)
        if x.device.type != "cuda":
            raise ValueError(f"no prune kernel for device {x.device}")
        _check_prune_args(x, cand, nlocal_pad, validu, rcap, sent16)
        nu, cc = cand.shape
        rows = torch.empty((nu, rcap), dtype=cand.dtype, device=x.device)
        numrows = torch.empty((nu,), dtype=torch.int64, device=x.device)
        if nu == 0:
            return rows, numrows
        lib = _build.load()
        fn = lib.verlet_prune_f32 if x.dtype == torch.float32 else lib.verlet_prune_f64
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), cand.data_ptr(), validu.data_ptr(), rows.data_ptr(),
                     numrows.data_ptr(), nu, cc, rcap, sent16, x.shape[0] // 16,
                     float(cutsq), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"verlet_prune launch failed: CUDA error {err}")
        PRUNE_LAUNCHES += 1
        return rows, numrows


def derive_rowlists_from_cells(grid: CellGrid, cl: CellList, x, nlocal: int,
                               nlocal_pad: int, rcap: int, cutneigh: float,
                               brcap: int = 8, ucol: int = 4, zw: int = 4,
                               ccap: int = 128):
    """Row lists straight from the cell table (mdbench_tpu's
    derive_rowlists_from_cells): per cell its distinct 16-rows with their
    bboxes; per unit the 3x3 xy stencil of each of its distinct columns,
    each read as one run of zw cells from the column's own zmin - 1; a
    bbox gap test against the unit's bbox; dedup; then the exact prune.
    Needs cell-sorted ghosts and bin-sorted locals to keep rows per cell
    few. Returns (rows (nu, rcap) int32, numrows (nu,) int32, stats (4,)
    int64 observed maxima [candidates, distinct columns, column z span,
    rows per cell], overflow)."""
    nrows = x.shape[0]
    if nrows % 16 or nlocal_pad % 16 or rcap % 8:
        raise ValueError("nrows and nlocal_pad must be multiples of 16, rcap of 8")
    dev = x.device
    nu = nlocal_pad // 16
    sent16 = nrows // 16 - 1
    sentinel_row = nrows - 1
    ZW = zw
    d2 = grid.dims[2]

    # 1. distinct 16-rows per cell (cell content is row-ascending)
    cells = cl.cells
    r16 = cells // 16
    firstc = (cells != sentinel_row) & _first_mask(r16, -1)
    cntc = firstc.sum(1)
    bin_rows = _compact(firstc, r16, brcap, sent16)  # (nbins + 1, brcap)
    bovf = (cntc > brcap).any()

    # per-row bboxes over the rows' real atoms
    n16r = nrows // 16
    xm, ym, zm = (x[:, k].reshape(n16r, 16) for k in range(3))
    validr = xm.abs() < 1e29
    bb = []
    for p in (xm, ym, zm):
        bb += list(_unit_bounds(p, validr))
    bb6 = torch.stack(bb, dim=1)[bin_rows]  # (nbins + 1, brcap, 6)

    # z-run tables: row b covers cells b .. b + ZW - 1 (z is the fastest
    # cell index); one more all-empty run at the end for dead slots
    nb1 = bin_rows.shape[0]

    def zrun(tbl, fill):  # (nb1, brcap, ...) -> (nb1 + 1, ZW, brcap, ...)
        tp = torch.cat([tbl, tbl.new_full((ZW + 1, *tbl.shape[1:]), fill)])
        return torch.stack([tp[i : i + nb1 + 1] for i in range(ZW)], dim=1)

    run_ids = zrun(bin_rows, sent16)
    run_bb = zrun(bb6, FBIG)
    empty_cell = nb1

    # 2. per-unit distinct columns, each with its own z window
    dcol, dzlo, _, n_dc, czspan, validu = _unit_columns(grid, x, nlocal, nlocal_pad,
                                                        ucol)
    sovf = (n_dc > ucol).any()
    zovf = (czspan + 3 > ZW).any()
    coloff = column_offsets(grid, dev)
    zroot = (dzlo - 1).clamp(min=0)
    dcells = torch.where(
        dcol[:, :, None] < COL_BIG,
        (dcol[:, :, None] + coloff[None, None, :]) * d2 + zroot[:, :, None],
        empty_cell,
    ).reshape(nu, ucol * 9).clamp(0, empty_cell)
    ubb = [_unit_bounds(x[:nlocal_pad, k].reshape(nu, 16), validu) for k in range(3)]

    Wc = ucol * 9 * ZW * brcap
    cutsq = cutneigh * cutneigh
    cc = min(ccap, Wc)
    cands, ncs = [], []
    for sl in _chunks(nu, Wc * 12):
        base = dcells[sl]
        n = base.shape[0]
        ids = run_ids[base].reshape(n, Wc)
        rb = run_bb[base]  # (n, ucol * 9, ZW, brcap, 6)
        dsq = None
        for k, (lo_i, hi_i) in enumerate(ubb):
            lo_j = rb[..., 2 * k].reshape(n, Wc)
            hi_j = rb[..., 2 * k + 1].reshape(n, Wc)
            g = torch.maximum(lo_i[sl][:, None] - hi_j, lo_j - hi_i[sl][:, None])
            g = g.clamp(min=0.0)
            dsq = g * g if dsq is None else dsq + g * g
        cand = torch.where(dsq <= cutsq, ids, sent16)
        s = torch.sort(cand, dim=1).values
        first = _first_mask(s, sent16)
        ncs.append(first.sum(1))
        cands.append(_compact(first, s, cc, sent16))
    cand = torch.cat(cands)
    ncs = torch.cat(ncs)
    covf = (ncs > cc).any()

    rows, numrows = _exact_prune(x, cand, nlocal_pad, validu, cutsq, rcap, sent16)
    overflow = bovf | sovf | zovf | covf | (numrows > rcap).any()
    stats = torch.stack([ncs.max(), n_dc.max(), czspan.max(), cntc.max()])
    return (rows.to(torch.int32).contiguous(), numrows.to(torch.int32), stats,
            overflow)


def range_candidates_ref(grid: CellGrid, x, nlocal: int, nlocal_pad: int, gcap: int,
                         cutneigh: float, ucol: int, kcap: int, ccap: int):
    """The plain version of `_range_candidates`, in torch ops on any device:
    the candidate stage of derive_rowlists_from_ranges. Per unit: its
    distinct columns' 3x3 stencils, an xy gap test of the unit bbox
    against each stencil column, the z range of its cells as one
    contiguous range of 16-row ids per block (locals, ghosts at rows
    [nlocal_pad, nlocal_pad + gcap)), at most kcap non-empty ranges sorted
    by their start and trimmed to disjoint intervals, their rows
    enumerated in order (at most ccap), in chunks of units. Returns (cand
    (nu, ccap) int64, total, n_dc, nk (nu,) int64: the union's length,
    the distinct columns, the non-empty ranges)."""
    dev, dtype = x.device, x.dtype
    nu = nlocal_pad // 16
    sent16 = x.shape[0] // 16 - 1
    d0, d1, d2 = grid.dims
    ncols = d0 * d1
    cutsq = cutneigh * cutneigh

    # per-cell start tables of the two blocks; column c's starts are
    # starts[c * d2 : c * d2 + d2 + 1] (lane d2: the column's end)
    q = torch.arange(grid.nbins + 1, device=dev)
    starts_l = torch.searchsorted(coord_to_bin(grid, x[:nlocal]), q)
    starts_g = torch.searchsorted(coord_to_bin(grid, x[nlocal_pad : nlocal_pad + gcap]), q)
    cidx = (torch.arange(ncols, device=dev)[:, None] * d2
            + torch.arange(d2 + 1, device=dev)[None, :])
    zero = torch.zeros((1, d2 + 1), dtype=starts_l.dtype, device=dev)
    tab_l = torch.cat([starts_l[cidx], zero])  # (ncols + 1, d2 + 1)
    tab_g = torch.cat([starts_g[cidx], zero])

    dcol, dzlo, dzhi, n_dc, _, validu = _unit_columns(grid, x, nlocal, nlocal_pad,
                                                      ucol)
    (uxlo, uxhi), (uylo, uyhi) = (
        _unit_bounds(x[:nlocal_pad, k].reshape(nu, 16), validu) for k in range(2))
    coloff = column_offsets(grid, dev)
    K9 = ucol * 9
    base16g = nlocal_pad // 16
    bs0, bs1 = (float(b) for b in np.asarray(grid.binsize[:2], np_dtype(dtype)))
    lpos = torch.arange(ccap, device=dev)
    cands, totals, nks = [], [], []
    for sl in _chunks(nu, 2 * K9 * (d2 + 1) * 4 + ccap * 8):
        dc, zl, zh = dcol[sl], dzlo[sl], dzhi[sl]
        n = dc.shape[0]
        cs = torch.where(dc[:, :, None] < COL_BIG, dc[:, :, None] + coloff[None, None, :],
                         ncols).clamp(0, ncols)  # (n, ucol, 9); ncols: dead row
        # unit bbox against the stencil column's xy rectangle (bin b
        # covers [(b - 1) * bs, b * bs) after the +1 margin shift)
        bxc = (cs // d1).to(dtype)
        byc = (cs % d1).to(dtype)
        gx = torch.maximum((bxc - 1.0) * bs0 - uxhi[sl][:, None, None],
                           uxlo[sl][:, None, None] - bxc * bs0).clamp(min=0.0)
        gy = torch.maximum((byc - 1.0) * bs1 - uyhi[sl][:, None, None],
                           uylo[sl][:, None, None] - byc * bs1).clamp(min=0.0)
        keepc = (gx * gx + gy * gy <= cutsq) & (cs < ncols)
        z0 = (zl - 1).clamp(min=0)[:, :, None].expand(n, ucol, 9)
        z1 = (zh + 1).clamp(max=d2 - 1)[:, :, None].expand(n, ucol, 9)

        def rng(tab, base):
            t = tab[cs]  # (n, ucol, 9, d2 + 1)
            a0 = torch.gather(t, 3, z0[..., None])[..., 0]
            a1 = torch.gather(t, 3, (z1 + 1)[..., None])[..., 0]
            ok = keepc & (a1 > a0)
            rlo = torch.where(ok, base + (a0 >> 4), RBIG)
            rhi = torch.where(ok, base + ((a1 - 1) >> 4) + 1, RBIG)
            return rlo.reshape(n, K9), rhi.reshape(n, K9)

        llo, lhi = rng(tab_l, 0)
        glo, ghi = rng(tab_g, base16g)
        rlo = torch.cat([llo, glo], dim=1)
        rhi = torch.cat([lhi, ghi], dim=1)
        # ranges by start (the order among equal starts does not change
        # the union enumerated below); at most kcap of them
        rlo_s, order = torch.sort(rlo, dim=1)
        rhi_s = torch.gather(rhi, 1, order)
        nks.append((rlo_s < RBIG).sum(1))
        rlo_s, rhi_s = rlo_s[:, :kcap], rhi_s[:, :kcap]
        live = rlo_s < RBIG
        # trim overlaps (the only duplicates) to disjoint intervals
        cm = torch.cummax(torch.where(live, rhi_s, 0), dim=1).values
        pm = torch.nn.functional.pad(cm[:, :-1], (1, 0), value=0)
        lo2 = torch.maximum(rlo_s, torch.minimum(pm, rhi_s))
        ln = torch.where(live, (rhi_s - lo2).clamp(min=0), 0)
        ends = torch.cumsum(ln, dim=1)
        total = ends[:, -1]
        # slot t of the enumeration lies in the first range whose end > t
        k = torch.searchsorted(ends, lpos[None, :].expand(n, ccap).contiguous(),
                               right=True).clamp(max=ln.shape[1] - 1)
        start = torch.gather(ends - ln, 1, k)
        cand = torch.gather(lo2, 1, k) + (lpos[None, :] - start)
        cands.append(torch.where(lpos[None, :] < total[:, None], cand, sent16))
        totals.append(total)
    return torch.cat(cands), torch.cat(totals), n_dc, torch.cat(nks)


def _check_ranges_args(x, bins, starts_l, starts_g, nlocal: int, nlocal_pad: int,
                       dims, ucol: int, kcap: int, ccap: int):
    """The operands the candidate kernel takes (raises on any other): x
    (nrows, 3) float32 or float64, contiguous, nrows a multiple of 16 with
    nrows / 16 < RBIG; 0 <= nlocal <= nlocal_pad <= nrows, nlocal_pad a
    multiple of 16; bins (nlocal_pad,) and starts_l, starts_g (nbins + 1,)
    int64, contiguous, on x's device; ucol and kcap >= 1, ccap >= 0;
    sizes within int32."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    named = {"bins": bins, "starts_l": starts_l, "starts_g": starts_g}
    for name, t in named.items():
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or x.shape[0] % 16:
        raise ValueError(f"x must be (nrows, 3) with nrows a multiple of 16, got "
                         f"{tuple(x.shape)}")
    if nlocal_pad % 16 or not 0 <= nlocal <= nlocal_pad <= x.shape[0]:
        raise ValueError(f"need 0 <= nlocal {nlocal} <= nlocal_pad {nlocal_pad} (a "
                         f"multiple of 16) <= x's {x.shape[0]} rows")
    nbins = dims[0] * dims[1] * dims[2]
    if tuple(bins.shape) != (nlocal_pad,):
        raise ValueError(f"bins must be ({nlocal_pad},), got {tuple(bins.shape)}")
    for name in ("starts_l", "starts_g"):
        if tuple(named[name].shape) != (nbins + 1,):
            raise ValueError(f"{name} must be ({nbins + 1},), got "
                             f"{tuple(named[name].shape)}")
    if not all(t.is_contiguous() for t in (x, *named.values())):
        raise ValueError("x, bins, starts_l and starts_g must be contiguous")
    if any(t.device != x.device for t in named.values()):
        raise ValueError("x, bins, starts_l and starts_g must be on one device")
    if x.shape[0] // 16 >= RBIG or nbins + 1 >= 2**31 or max(ucol, kcap, ccap) >= 2**31:
        raise ValueError("sizes must fit in int32, and the 16-row ids below RBIG")
    if ucol < 1 or kcap < 1 or ccap < 0:
        raise ValueError(f"need ucol {ucol} and kcap {kcap} >= 1, ccap {ccap} >= 0")


def _ranges_kernel(grid: CellGrid, x, bins, starts_l, starts_g, nlocal: int,
                   nlocal_pad: int, cutneigh: float, ucol: int, kcap: int, ccap: int):
    """One launch of ``csrc/verlet_ranges.cu`` on the current stream, on x,
    the unit rows' bins and the two start tables (_check_ranges_args says
    what it takes; they are checked first, and a launch error raises).
    Returns (cand (nu, ccap) int64, counts (3, nu) int64 [total, n_dc,
    nk], stats (4,) int64 [max total, max n_dc, max nk, 0])."""
    global RANGES_LAUNCHES
    _check_ranges_args(x, bins, starts_l, starts_g, nlocal, nlocal_pad, grid.dims, ucol,
                       kcap, ccap)
    dev = x.device
    nu = nlocal_pad // 16
    cand = torch.empty((nu, ccap), dtype=torch.int64, device=dev)
    counts = torch.empty((3, nu), dtype=torch.int64, device=dev)
    stats = torch.zeros((4,), dtype=torch.int64, device=dev)
    if nu == 0:
        return cand, counts, stats
    lib = _build.load()
    fn = lib.verlet_ranges_f32 if x.dtype == torch.float32 else lib.verlet_ranges_f64
    bs0, bs1 = (float(b) for b in np.asarray(grid.binsize[:2], np_dtype(x.dtype)))
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), bins.data_ptr(), starts_l.data_ptr(), starts_g.data_ptr(),
                 cand.data_ptr(), counts.data_ptr(), stats.data_ptr(), nu, nlocal, ucol,
                 kcap, ccap, *grid.dims, x.shape[0] // 16 - 1, bs0, bs1,
                 float(cutneigh * cutneigh), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"verlet_ranges launch failed: CUDA error {err}")
    RANGES_LAUNCHES += 1
    return cand, counts, stats


def _range_candidates(grid: CellGrid, x, nlocal: int, nlocal_pad: int, gcap: int,
                      cutneigh: float, ucol: int, kcap: int, ccap: int):
    """The candidate stage of derive_rowlists_from_ranges (mdbench_tpu's,
    before the prune): per unit the first ccap ids of the union of its
    stencil columns' row ranges (range_candidates_ref says how). Returns
    (cand (nu, ccap) int64, total, n_dc, nk (nu,) int64, stats (4,) int64
    [max total, max n_dc, max nk, 0]). On a CPU tensor by
    `range_candidates_ref`; on a CUDA tensor the bins of rows [0,
    nlocal_pad + gcap) (coord_to_bin) and the two start tables in torch
    ops, then one launch of ``csrc/verlet_ranges.cu`` (`_ranges_kernel`;
    built from csrc/ at first use): the same bits, but that where nk >
    kcap (an overflow) the ranges kept among equal starts may differ, and
    with them cand and total, and that a real atom whose first coordinate
    is at or past +-SENTINEL_COORD / 2 (a trajectory that has blown up)
    counts in the trap bin here, in a margin bin in the plain version.
    Any other device raises."""
    if x.device.type == "cpu":
        cand, total, n_dc, nk = range_candidates_ref(grid, x, nlocal, nlocal_pad, gcap,
                                                     cutneigh, ucol, kcap, ccap)
        stats = torch.stack([total.max(), n_dc.max(), nk.max(),
                             torch.zeros_like(nk.max())])
        return cand, total, n_dc, nk, stats
    if x.device.type != "cuda":
        raise ValueError(f"no ranges kernel for device {x.device}")
    bins = coord_to_bin(grid, x[: nlocal_pad + gcap])
    q = torch.arange(grid.nbins + 1, device=x.device)
    starts_l = torch.searchsorted(bins[:nlocal], q)
    starts_g = torch.searchsorted(bins[nlocal_pad:], q)
    cand, counts, stats = _ranges_kernel(grid, x, bins[:nlocal_pad], starts_l, starts_g,
                                         nlocal, nlocal_pad, cutneigh, ucol, kcap, ccap)
    return cand, *counts, stats


def derive_rowlists_from_ranges(grid: CellGrid, x, nlocal: int, nlocal_pad: int,
                                gcap: int, rcap: int, cutneigh: float, ucol: int = 4,
                                kcap: int = 40, ccap: int = 128):
    """Row lists from contiguous row ranges (mdbench_tpu's
    derive_rowlists_from_ranges, the sort-free rebuild): with bin-sorted
    locals and cell-sorted ghosts, each stencil column's candidates for a
    unit are one contiguous range of 16-row ids per block; the candidate
    stage (`_range_candidates`: on a CUDA tensor one kernel launch), then
    the exact prune (`_exact_prune`). The same rows as
    derive_rowlists_from_cells. Returns (rows, numrows, stats
    [candidates, distinct columns, non-empty ranges, 0], overflow)."""
    nrows = x.shape[0]
    if nrows % 16 or nlocal_pad % 16 or rcap % 8:
        raise ValueError("nrows and nlocal_pad must be multiples of 16, rcap of 8")
    cand, _, _, _, stats = _range_candidates(grid, x, nlocal, nlocal_pad, gcap, cutneigh,
                                             ucol, kcap, ccap)
    validu = (torch.arange(nlocal_pad, device=x.device) < nlocal).reshape(-1, 16)
    cutsq = cutneigh * cutneigh
    rows, numrows = _exact_prune(x, cand, nlocal_pad, validu, cutsq, rcap, nrows // 16 - 1)
    overflow = ((stats[0] > ccap) | (stats[1] > ucol) | (stats[2] > kcap)
                | (numrows > rcap).any())
    return (rows.to(torch.int32).contiguous(), numrows.to(torch.int32), stats,
            overflow)


def compute_force_lj_rowlist(x, rows, numrows, nlocal_pad: int, cutforcesq: float,
                             sigma6: float, epsilon: float, approx_rcp: bool = False,
                             buckets=None, brows=None, bcrows=None, binv=None):
    """LJ force over the row lists, (nlocal_pad, 3) like the planar full
    force (the same pair set: the rows cover every list entry, self pairs
    drop out by rsq > 0, padding by the cutoff). The planes are
    x[:, d].reshape(-1, 8), copied contiguous (three copies a call); with
    the bucket maps (`buckets` = (sizes, caps) and brows, bcrows, binv)
    the bucketed force, else the flat one, each with share 2
    (module docstring). `approx_rcp` as in ops/lj_cluster."""
    if x.shape[0] % 16 or nlocal_pad % 16:
        raise ValueError("x rows and nlocal_pad must be multiples of 16")
    xc, yc, zc = (x[:, k].reshape(-1, 8).contiguous() for k in range(3))
    npad = nlocal_pad // 8
    lj = (cutforcesq, sigma6, epsilon)
    if buckets is not None and brows is not None:
        f3 = lj_cluster_force_buckets(xc, yc, zc, brows, bcrows, binv, numrows, npad,
                                      buckets, *lj, share=2, approx_rcp=approx_rcp)
    else:
        f3 = lj_cluster_force_ilist(xc, yc, zc, rows, numrows, npad, *lj, share=2,
                                    approx_rcp=approx_rcp)
    return torch.stack([f.reshape(-1) for f in f3], dim=1)
