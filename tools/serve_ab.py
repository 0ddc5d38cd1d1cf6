"""Serving A/B on one card: ``chip_smoke.py``'s serving phase (phase 4)
from several checkouts of the port, in turns, in one call.

    python3 tools/serve_ab.py DIR_A DIR_B [DIR_C ...]

The serving lane is host-bound and spreads widely from one machine to the
next, so a change is compared with its parent only inside one call, on one
card. Each checkout's phase runs in a process of its own from that
checkout's root (which builds its own kernels), in the order A, B, ...
and then reversed (..., B, A), by ``ab_runner.run_in_turns``. Prints one
JSON line per run (tok/s, TTFT and ITL p50, the decode breakdown) and the
card's name and power limit; exits 1 if a run fails.
"""
import sys

from ab_runner import run_in_turns

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
    return run_in_turns(CHILD, dirs, __doc__, mirror=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
