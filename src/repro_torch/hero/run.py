"""Benchmark driver: one section per paper table/figure + the roofline, the
port of ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.hero.run [--device cpu]

Prints ``name,us_per_call,derived`` CSV rows per section (the reference's
contract: ``derived`` is ``ok`` or ``error:<type>``), then the full
section outputs.  The sections are the reference's, under its names:
Fig.4 (with its measured half on SM-budgeted clusters of one card and
``--throughput``'s GIPS rows), Fig.5, Fig.6, Tab.2 and the single-pod
roofline table (both from the dry-run records under
``artifacts/dryrun_torch/``).  Unlike the reference, which always exits
0, it exits 1 after the outputs when a section failed.
"""
from __future__ import annotations

import argparse
import io
import sys
import time
import traceback
from contextlib import redirect_stdout

from repro_torch.device import DeviceLike


def _fig4(device):
    from repro_torch.hero import fig4_cluster_speedup
    fig4_cluster_speedup.main(throughput=True, device=device)


def _fig5(device):
    from repro_torch.hero import fig5_svm_offload
    fig5_svm_offload.main(device)


def _fig6(device):
    from repro_torch.hero import fig6_event_tracing
    fig6_event_tracing.main()


def _tab2(device):
    from repro_torch.hero import tab2_resources
    tab2_resources.main()


def _roofline(device):
    from repro_torch.hero import roofline_table
    print(roofline_table.render_markdown(roofline_table.full_table("single")))


#: (name, section): the reference's sections, in its order
SECTIONS = (("fig4_cluster_speedup", _fig4),
            ("fig5_svm_offload", _fig5),
            ("fig6_event_tracing", _fig6),
            ("tab2_resources", _tab2),
            ("roofline_single_pod", _roofline))


def _run(name, fn):
    buf = io.StringIO()
    t0 = time.perf_counter()
    status = "ok"
    try:
        with redirect_stdout(buf):
            fn()
    except Exception as e:  # noqa: BLE001  (reported, and main exits 1)
        status = f"error:{type(e).__name__}"
        buf.write(traceback.format_exc())
    dt = (time.perf_counter() - t0) * 1e6
    print(f"{name},{dt:.0f},{status}", flush=True)
    return name, buf.getvalue(), status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    device: DeviceLike = ap.parse_args(argv).device
    print("name,us_per_call,derived")
    sections = [_run(name, lambda fn=fn: fn(device))
                for name, fn in SECTIONS]
    for name, out, _ in sections:
        print(f"\n{'='*72}\n== {name}\n{'='*72}")
        print(out)
    return int(any(status != "ok" for _, _, status in sections))


if __name__ == "__main__":
    sys.exit(main())
