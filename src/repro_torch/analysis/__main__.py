"""CLI: ``python -m repro_torch.analysis`` — run the suite, gate on the baseline.

Exit status is 0 only when every finding is covered by
``analysis_baseline_torch.json`` AND no baseline entry is stale (two-sided
ratchet, see :mod:`repro_torch.analysis.baseline`). Typical invocations::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu --layers 1,2
    PYTHONPATH=src python -m repro_torch.analysis --layers 1   # fast AST only
    PYTHONPATH=src python -m repro_torch.analysis              # all, on the card
    PYTHONPATH=src python -m repro_torch.analysis --format github
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import BASELINE_NAME, compare, load_baseline, run_all, write_baseline
from .findings import RULE_CATALOG


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's contract suite (bit-parity / no-host-sync contracts)",
    )
    ap.add_argument("--root", default=".", help="repo root (default: cwd)")
    ap.add_argument("--layers", default="1,2,3",
                    help="comma list of layers to run (default: 1,2,3)")
    ap.add_argument("--device", default=None,
                    help="device of layers 2 and 3 (default: the CUDA card; layer 3 needs it)")
    ap.add_argument("--format", choices=("text", "github"), default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline (new entries get "
                         "a TODO justification that must be filled in before the file loads)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        # import for side effect: register every layer's rules
        from . import cuda, dispatch, rules  # noqa: F401
        for code in sorted(RULE_CATALOG):
            print(f"{code}  {RULE_CATALOG[code]}")
        return 0

    layers = tuple(int(x) for x in args.layers.split(",") if x.strip())
    bl_path = Path(args.baseline or Path(args.root) / BASELINE_NAME)

    rep = run_all(args.root, layers=layers, device=args.device)

    if args.write_baseline:
        write_baseline(bl_path, rep.findings)
        print(f"[analysis] wrote {len(rep.findings)} finding(s) to {bl_path}")
        return 0

    entries = load_baseline(bl_path)
    new, stale, accepted = compare(rep.sorted(), entries)

    for f in new:
        print(f.format(args.format))
    for e in stale:
        msg = (f"stale baseline entry no longer fires: {e.key!r} "
               f"({e.justification}) — delete it from {bl_path.name}")
        if args.format == "github":
            print(f"::error file={BASELINE_NAME},line=1,title=stale-baseline::{msg}")
        else:
            print(f"{bl_path.name}:1: stale-baseline {msg}")
    for f in accepted:
        print(f"[baselined] {f.key}")
    for line in rep.advisories:
        print(line)
    if args.format == "text":
        for name, rows in rep.tables.items():
            for row in rows:
                print(f"[{name}] {json.dumps(row)}")

    print(f"[analysis] layers={','.join(map(str, layers))} findings={len(rep.findings)} "
          f"new={len(new)} stale={len(stale)} baselined={len(accepted)}")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
