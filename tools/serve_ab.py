"""Serving A/B on one card: ``chip_smoke.py``'s serving phase (phase 4)
from several checkouts of the port, in turns, in one call.

    python3 tools/serve_ab.py DIR_A DIR_B [DIR_C ...]

The serving lane is host-bound and spreads widely from one machine to the
next, so a change is compared with its parent only inside one call, on one
card. Each checkout's phase runs in a process of its own from that
checkout's root (which builds its own kernels), in the order A, B, ...
and then reversed (..., B, A). Prints one JSON line per run (tok/s, TTFT
and ITL p50, the decode breakdown) and the card's name and power limit;
exits 1 if a run fails.
"""
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import inspect, json
import chip_smoke as cs
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.models import transformer as tt
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
common.kernel_library()
records = {n: {} for n in ("flash_decode_step", "flash_decode_step_paged")}
args = (serving, tt, fa, common, records)
if "common" not in inspect.signature(cs.serving_phase).parameters:
    args = (serving, tt, fa, records)
print("RESULT " + json.dumps(cs.serving_phase(*args)), flush=True)
'''


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    for d in dirs + dirs[::-1]:
        run = subprocess.run([sys.executable, "-c", CHILD], cwd=d,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            print(f"{d}: exit {run.returncode}\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        result = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps({"checkout": str(Path(d)), **result}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
