"""Layer-norm backward A/B on one card: the device and graph ms of
``layer_norm_bwd`` from several checkouts of the port, in turns, over a
sweep of row counts at d 768, in one call.

    python3 tools/ln_bwd_ab.py DIR_A DIR_B [DIR_C ...]

Each checkout's sweep runs in a process of its own from that checkout's
root (which builds its own kernels), in the order given, by
``ab_runner.run_in_turns``. A call is one wrapper call on its own rule's
route (the column partials summed where the checkout's kernel returns
partials, as its caller did), x and dy rotated through copies beyond the
50 MB L2 (``chip_smoke._Rotation``).
Rows n 1056 .. 32768 in float32 and bf16: the small counts read the
launch's fixed cost, the slope between the large ones its marginal
bandwidth. Prints one line per checkout, {"<type> <n>": [device ms, graph
ms]} under "checkout", and the card's name and power limit; exits 1 if a
run fails.
"""
import sys

from ab_runner import run_in_turns

CHILD = r'''
import json
import torch
import chip_smoke as cs
from incubator_mxnet_tpu_torch.ops.cuda import common, layer_norm as ln
common.kernel_library()
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for dt in (torch.float32, torch.bfloat16):
    for n in (1056, 2112, 8448, 16384, 32768):
        d = 768
        x = torch.randn((n, d), generator=g, device="cuda").to(dt)
        dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
        gam = torch.randn((d,), generator=g, device="cuda")
        _, mu, rstd = ln.layer_norm_reference(x, gam, gam)
        rot = cs._Rotation(x, dy)

        def one(a, b):
            dx, dg, db = ln.layer_norm_bwd(a, gam, mu, rstd, b)
            if dg.dim() == 2:
                dg, db = dg.sum(0), db.sum(0)
            return dx, dg, db

        def fn():
            return rot(one)
        dev, _ = cs.device_ms(fn, ln.layer_norm_bwd)
        out[f"{str(dt)[6:]} {n}"] = [dev, cs.graph_ms(fn)]
        del rot
print("RESULT " + json.dumps(out), flush=True)
'''


def main(dirs) -> int:
    return run_in_turns(CHILD, dirs, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
