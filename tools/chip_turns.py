#!/usr/bin/env python3
"""Time whole runs of ``chip_smoke.py`` from several checkouts, in turns, on one card.

Run on the machine with the card, from the root of a checkout:

    python3 tools/chip_turns.py PARENT_DIR CHANGE_DIR [--order 0110] [--log-dir build/chip_turns]

Each turn runs ``python3 chip_smoke.py`` from one checkout (``--order`` lists
the checkouts' indexes in turn; the default, 0110, runs parent, change,
change, parent, so each checkout builds its kernels in one of its runs and
finds them built in the other). It writes the run's output to
``<log-dir>/turn<i>_<dir name>.log`` and prints one line a turn: the exit
code, the wall seconds (the host clock around the process, the build
included) and the run's phase lines; then, last, one JSON line with every
turn's checkout, exit code and wall seconds. Whole runs move by 5-15%
between turns, so two versions are compared only within one call.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+", help="checkouts, each with its chip_smoke.py")
    ap.add_argument("--order", default="0110", help="indexes into DIRS, one a turn")
    ap.add_argument("--log-dir", default="build/chip_turns")
    args = ap.parse_args()
    log_dir = Path(args.log_dir).resolve()
    log_dir.mkdir(parents=True, exist_ok=True)
    dirs = [Path(d).resolve() for d in args.dirs]
    turns = []
    for i, k in enumerate(int(c) for c in args.order):
        log = log_dir / f"turn{i + 1}_{dirs[k].name or 'root'}.log"
        t0 = time.perf_counter()
        with open(log, "w") as out:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=dirs[k], stdout=out,
                                stderr=subprocess.STDOUT).returncode
        wall = time.perf_counter() - t0
        turns.append(dict(turn=i + 1, dir=str(dirs[k]), rc=rc, wall_s=wall))
        phases = re.findall(r"^\s*(phase [A-Z] [0-9.]+ s)", log.read_text(), re.M)
        print(f"turn {i + 1} {dirs[k]}: rc={rc} wall {wall:.1f} s; " + "; ".join(phases),
              flush=True)
    print(json.dumps({"turns": turns}))
    return max(t["rc"] for t in turns)


if __name__ == "__main__":
    sys.exit(main())
