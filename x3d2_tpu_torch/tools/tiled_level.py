"""The sharded step with the y/z-tiled mid against the single-card step
with the merged mid, on the CPU, in float32 and float64.

    python3 -m x3d2_tpu_torch.tools.tiled_level --dims 128 256 256 \\
        --steps 3 [--dtypes float32 float64]

Spawns the 4 ranks of a (2, 2) mesh (gloo, the CPU) with the full-plane
mid's VMEM gate closed in each rank's process, as x3d2_tpu's own tests
close theirs (tests/test_shard_kernels.py:301-341): the repencilled
projection then takes the tiled mid at a grid small enough for the CPU,
where it would take the full-plane one. Each rank steps TGV AB3
(keep_pressure=False) through shard_run; rank 0 then steps the single-card
case of the same arithmetic (shard_run's reference: the unfused AB step,
the one-field parity x stage, the merged mid with q). Prints, per dtype,
max |d| / max |u| over u, v, w: in float64 the two mids differ by the
reassociation of their y and z stages only, in float32 by its rounding,
from which chip_smoke.py's phase 9 reads its tolerance for the tiled run.
"""

from __future__ import annotations

import argparse


def tiled_ranks(rank, world, specs):
    """shard_run's ranks with the full-plane mid's VMEM gate closed in the
    rank's process (the repencilled projection reads it when it is built),
    so that the repencilled projection takes the tiled mid."""
    from ..ops import pressure_slab
    from .shard_run import tgv_ranks

    pressure_slab.tpu_slab_vmem_ok = lambda solver, terms: False
    return tgv_ranks(rank, world, specs)


def measure(dims, steps, dtypes, threads=1):
    """{dtype: (the mid the ranks took, max |d| / max |u|)}."""
    from ..parallel.multihost import spawn

    specs = [{"dims": tuple(dims), "mesh": (2, 2), "dtype": dt,
              "device": "cpu", "steps": steps, "reference": True}
             for dt in dtypes]
    res = spawn(tiled_ranks, 4, (specs,), threads=threads)
    out = {}
    for i, dt in enumerate(dtypes):
        cmp = res[0][i]["compare"]
        err = max(cmp["diffs"][k] for k in ("u", "v", "w")) / cmp["scale"]
        out[dt] = ({r[i]["mid"] for r in res}, err)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(128, 256, 256))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    args = ap.parse_args(argv)
    for dt, (mids, err) in measure(args.dims, args.steps,
                                   args.dtypes).items():
        print(f"TGV {'x'.join(map(str, args.dims))} on (2, 2), {dt}, "
              f"{args.steps} steps, mid {sorted(mids)}: sharded (tiled mid) "
              f"vs single card (merged mid): max |d| / max |u| {err:.3e}")


if __name__ == "__main__":
    main()
