#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with every one of its module-level functions
timed, to see where the script's time goes.

    python3 scripts/time_chip_smoke.py [--out chip_smoke_times.txt]

Runs ``chip_smoke.main()`` as ``python3 chip_smoke.py`` does (its output
and exit code unchanged), each function of the module wrapped in a
host-clock timer.  ``--out`` gets, also when a phase fails: every call
that took over a second, as a tree (its start in seconds from the first
call, its inclusive seconds), then each function's inclusive total and
call count.  Inclusive: a function's time holds its callees'.  The
wrappers cost microseconds a call."""
import argparse
import atexit
import collections
import functools
import inspect
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chip_smoke_times.txt")
    out = Path(ap.parse_args().out)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    totals, counts, tree = collections.defaultdict(float), \
        collections.Counter(), []
    depth = [0]
    t0 = time.perf_counter()

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            d = depth[0]
            depth[0] += 1
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - start
                depth[0] = d
                totals[name] += dt
                counts[name] += 1
                if dt > 1.0:
                    tree.append((start - t0, d, name, dt))
        return timed

    for name, obj in list(vars(chip_smoke).items()):
        if inspect.isfunction(obj) and obj.__module__ == "chip_smoke" \
                and name not in ("main", "check"):
            setattr(chip_smoke, name, wrap(name, obj))

    def dump():
        with open(out, "w") as f:
            f.write("# calls over 1 s: start s, inclusive s\n")
            for start, d, name, dt in sorted(tree):
                f.write(f"{start:9.2f} {'  ' * d}{name} {dt:.2f}\n")
            f.write("# totals: inclusive s, calls\n")
            for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
                f.write(f"{t:9.2f} {counts[name]:6d} {name}\n")
    atexit.register(dump)
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
