#!/usr/bin/env python3
"""The dry run's shipped collectives of reduced cells beside the
reference's compiled HLO, on the host's CPU (no card).

    PYTHONPATH=src python3 tools/dryrun_hlo_probe.py [--cell ARCH SHAPE D M ...]

For each cell (default: reduced Qwen2.5-32B ``decode_32k`` on a
``(1, 4)`` ``("data", "model")`` mesh, whose 2 KV heads the ``model`` axis
cuts along the head dim) prints, by the reference's five kinds, the
counts and shipped bytes of ``repro_torch.launch.dryrun.collectives``
(the walk) and of ``hlo_analysis.analyze_compiled`` on the reference's
``lower_cell`` compiled over 4 forced host devices
(``tests/test_torch_dryrun.py``'s reference code, in a subprocess), and
the ratio of the totals, walk / HLO. Takes some ten seconds a cell.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..", "tests")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", nargs=4, action="append", metavar=("ARCH", "SHAPE", "DATA", "MODEL"))
    args = ap.parse_args(argv)
    cells = [(a, s, (int(d), int(m))) for a, s, d, m in (args.cell or [("qwen2.5-32b", "decode_32k", 1, 4)])]

    import test_torch_dryrun as T
    from conftest import run_subprocess
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    for arch, sname, dims in cells:
        code = T.REF_CODE.replace("__CELLS__", repr([(arch, sname)])).replace("__GRIDS__", repr([dims]))
        out = run_subprocess(code, devices=4, timeout=900)
        ref = json.loads(next(x for x in out.splitlines() if x.startswith("RESULT"))[len("RESULT"):])
        ref = ref[f"{arch}|{sname}|{dims[0]},{dims[1]}"]
        walk = dryrun.collectives(get_config(arch, reduced=True), SHAPES[sname], MeshShape(dims, ("data", "model")))
        hlo = {k: float(ref["coll_bytes"].get(k, 0.0)) for k in dryrun.KINDS}
        print(f"{arch} {sname} {dims} reduced: shipped bytes a rank by kind (counts)")
        for k in dryrun.KINDS:
            print(f"  {k:20s} walk {walk['bytes'][k]:14.1f} ({walk['counts'][k]:3d})   "
                  f"reference HLO {hlo[k]:14.1f} ({int(ref['coll_counts'].get(k, 0)):3d})")
        total, ref_total = sum(walk["bytes"].values()), sum(hlo.values())
        print(f"  total walk {total:.1f} B, reference HLO {ref_total:.1f} B, walk / HLO "
              f"{total / max(ref_total, 1.0):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
