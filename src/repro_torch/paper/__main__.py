"""The paper's tables on the port, one section per table (the paper
sections of the reference's ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows and the rendered markdown
tables. Results are cached under experiments/bench_torch/, so re-runs
are incremental; a section that fails is reported and makes the exit
code non-zero.

    PYTHONPATH=src python -m repro_torch.paper --setting reference --device cpu
    PYTHONPATH=src python -m repro_torch.paper --setting full --only table2,fig3
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch.paper import (fig3_homogenize, table2_noniid,
                               table3_topology, table4_public, table6_comm,
                               table7_scale)

SECTIONS = {
    "table2": table2_noniid.run,
    "table3": table3_topology.run,
    "table4": table4_public.run,
    "table6": table6_comm.run,
    "table7": table7_scale.run,
    "fig3": lambda **kw: fig3_homogenize.run(**kw)[:2],
}

RENDERERS = {
    "table2": table2_noniid.render,
    "table3": table3_topology.render,
    "table4": table4_public.render,
    "table6": table6_comm.render,
    "table7": table7_scale.render,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--setting", default="reference",
                    choices=("reference", "full"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = (args.only.split(",") if args.only else list(SECTIONS))
    print("name,us_per_call,derived")
    failures = []
    for name in names:
        t0 = time.time()
        try:
            rows, csv = SECTIONS[name](setting=args.setting,
                                       device=args.device)
        except Exception:  # noqa: BLE001 — keep the report going
            traceback.print_exc()
            failures.append(name)
            continue
        for row in csv:
            print(",".join(str(x) for x in row), flush=True)
        if name in RENDERERS and rows:
            print(f"\n## {name}\n{RENDERERS[name](rows)}\n", flush=True)
        elif rows:
            print(f"\n## {name}\n{rows}\n", flush=True)
        print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"paper sections failed: {failures}")


if __name__ == "__main__":
    main()
