"""The checkout-in-turns runner of the A/B tools (``serve_ab.py``,
``ln_bwd_ab.py``): one child script run from several checkouts of the
port, each in a process of its own from that checkout's root (so it builds
and imports that checkout's kernels and code), on one card, in one call.

A child prints its result as one ``RESULT <json object>`` line.
"""
import json
import subprocess
import sys
from pathlib import Path


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def run_in_turns(child: str, dirs, doc: str, mirror: bool = False,
                 timeout: int = 900) -> int:
    """Runs ``child`` from each checkout of ``dirs`` in order (then in the
    reverse order too with ``mirror``), printing one JSON line per run,
    {"checkout": dir, **result}, then the card's name and power limit. A
    failed run prints its exit code and the end of its stderr, and the
    others still run. Returns 2 (and prints ``doc``) without checkouts, 1
    if a run failed, else 0."""
    if not dirs:
        print(doc, file=sys.stderr)
        return 2
    failed = False
    for d in list(dirs) + (list(dirs)[::-1] if mirror else []):
        run = subprocess.run([sys.executable, "-c", child], cwd=d,
                             capture_output=True, text=True, timeout=timeout)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            failed = True
            print(f"{d}: exit {run.returncode}\n{run.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            continue
        result = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps({"checkout": str(Path(d)), **result}), flush=True)
    print(card_line(), flush=True)
    return 1 if failed else 0
