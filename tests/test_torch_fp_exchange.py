"""The cluster EAM force split at the fp plane (ops/eam_cluster:
`eam_cluster_density`, the caller's ghost fp, `eam_cluster_pair_forces`;
the cluster slab engine fills the ghost rows by its own exchange between
the passes, where mdbench_tpu's eam_cluster_force_xla takes an
fp_exchange callable), and the type-table cutoff check of
ClusterSimulation, on the CPU in float64:

- the two passes with the default fill (the owners' fp through the
  border map) give eam_cluster_force's bits, through the plain versions
  and the wrappers, flat and bucketed; pass 1 leaves the ghost rows 0;
- another fill (the ghost rows' fp halved) gives mdbench_tpu's forces for
  the same fill as its fp_exchange on a jittered 4^3 box (rel 1e-12);
- tables whose cutoff exceeds cutforce raise ValueError (mdbench_tpu
  accepts them and loses the pairs past cutneigh)."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import hand_plan, write_standin_funcfl
from mdbench_tpu.ops.eam_cluster import _fp_ghost_refresh as j_refresh
from mdbench_tpu.ops.eam_cluster import eam_cluster_force_xla
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.convert import clusters_from_numpy, eam_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops.cluster import bucket_maps_core
from test_torch_eam import _engine_case

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    cl, pairs, border_map, npad, share, tables, poly = _engine_case(str(path), 2)
    c = clusters_from_numpy(cl, "cpu", torch.float64)
    pr = pairs_from_numpy(pairs, "cpu")
    eam_t, poly_t = eam_from_numpy(tables, poly, "cpu", torch.float64)
    return dict(cl=cl, pairs=pairs, bm_np=border_map, planes=(c.xc, c.yc, c.zc),
                ijlist=pr.ijlist, nji=pr.nji,
                bm=torch.tensor(border_map, dtype=torch.int64), npad=npad, share=share,
                cut2=tables.cut**2, eam=eam_t, poly=poly_t, tables=tables, poly_np=poly)


def _split(a, fill, wrapper, **kw):
    """The two passes through the plain versions or the wrappers, the
    ghost rows filled by fill(fp) in between: (fx, fy, fz, fp)."""
    npad, cut2 = a["npad"], a["cut2"]
    if wrapper:
        fp = tec.eam_cluster_density(*a["planes"], a["ijlist"], a["nji"], npad, cut2,
                                     a["eam"], a["poly"], **kw)
        assert not fp[npad:].any()
        fill(fp)
        f = tec.eam_cluster_pair_forces(*a["planes"], fp, a["ijlist"], a["nji"], npad,
                                        cut2, a["poly"], **kw)
    else:
        fp = tec.eam_cluster_density_ref(*a["planes"], a["ijlist"], npad, cut2, a["eam"],
                                         a["poly"], **kw)
        assert not fp[npad:].any()
        fill(fp)
        f = tec.eam_cluster_pair_forces_ref(*a["planes"], fp, a["ijlist"], npad, cut2,
                                            a["poly"], **kw)
    return (*f, fp)


def _halve_ghosts_t(bm, npad):
    def fill(fp):
        tec._fp_ghost_refresh(fp, bm, npad)
        fp[npad:] *= 0.5
    return fill


@pytest.mark.parametrize("bucketed", [False, True])
def test_default_callable_gives_the_same_bits(case, bucketed):
    a = case
    kw = dict(share=a["share"])
    if bucketed:
        plan = hand_plan(a["nji"].numpy(), a["ijlist"].shape[1])
        maps = bucket_maps_core(a["ijlist"], a["nji"], a["npad"], a["share"],
                                a["planes"][0].shape[0], *plan)
        kw.update(buckets=plan, bpairs=maps[:3])
    want = tec.eam_cluster_force_ref(*a["planes"], a["ijlist"], a["bm"], a["npad"],
                                     a["cut2"], a["eam"], a["poly"], **kw)
    for wrapper in (False, True):
        got = _split(a, lambda fp: tec._fp_ghost_refresh(fp, a["bm"], a["npad"]),
                     wrapper, **kw)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_other_callable_matches_jax(case):
    a = case
    if len(jax.devices()) < 1:
        pytest.skip("no jax device")
    import jax.numpy as jnp
    from mdbench_tpu.ops.eam import EamDevice as JEamDevice

    bm_j = jnp.asarray(a["bm_np"])
    npad = a["npad"]

    def halve_j(fp):
        return j_refresh(fp, bm_j, npad).at[npad:].multiply(0.5)

    jp = [jnp.asarray(a["cl"][k]) for k in ("xc", "yc", "zc")]
    jeam = JEamDevice.from_tables(a["tables"], jnp.float64)
    *f_j, fp_j = jax.jit(lambda *arr: eam_cluster_force_xla(
        *arr, npad, a["cut2"], jeam, a["poly_np"], share=a["share"],
        fp_exchange=halve_j))(*jp, jnp.asarray(a["pairs"]["ijlist"]), bm_j)
    scale = max(np.abs(np.asarray(f)).max() for f in f_j)
    *f_t, fp_t = _split(a, _halve_ghosts_t(a["bm"], npad), False, share=a["share"])
    for x, y in zip(f_t, f_j):
        assert np.abs(x.numpy() - np.asarray(y)).max() <= 1e-12 * scale
    np.testing.assert_allclose(fp_t.numpy(), np.asarray(fp_j), rtol=1e-12, atol=1e-14)
    # the wrappers take the same fill to the same bits on the CPU
    for x, y in zip(_split(a, _halve_ghosts_t(a["bm"], npad), True, share=a["share"]),
                    (*f_t, fp_t)):
        assert torch.equal(x, y)
    # the fill took effect: the default refresh gives other forces
    *f_d, _ = tec.eam_cluster_force_ref(*a["planes"], a["ijlist"], a["bm"], npad,
                                        a["cut2"], a["eam"], a["poly"], share=a["share"])
    assert max(float((x - y).abs().max()) for x, y in zip(f_t, f_d)) > 1e-6 * scale


@pytest.mark.parametrize("cut,ok", [(2.5, True), (2.5 + 1e-9, False), (2.6, False)])
def test_tables_past_cutforce_raise(cut, ok):
    def build():
        tables = (np.ones((2, 2)), np.ones((2, 2)), np.full((2, 2), 2.5**2))
        tables[2][0, 1] = tables[2][1, 0] = cut**2
        return ClusterSimulation(Params(nx=4, ny=4, nz=4, scheme="cluster", ntypes=2),
                                 types=np.arange(256) % 2, tables=tables, device="cpu")

    if ok:
        assert build().ntypes == 2
    else:
        with pytest.raises(ValueError, match="exceeds cutforce"):
            build()
