"""MD-Bench's own temperature trace for its default workload (32^3 FCC
cells, 131,072 atoms, 200 steps), printed by the C reference built in
double precision (MDBench-VL-GCC-X86-DP, `nstat 10`): step -> T. It is
the reference velocities', so it applies to seed 0 alone, and is printed
beside a run for information; the judge compares the reference of
md.py."""

GOLDEN_TEMP = {
    "lj_fcc_131k": {
        20: 6.895877e-01, 40: 6.637927e-01, 60: 8.179967e-01,
        80: 8.584812e-01, 100: 8.200911e-01, 120: 8.084264e-01,
        140: 8.014512e-01, 160: 7.924040e-01, 180: 7.959717e-01,
        200: 7.961535e-01,
    },
}
