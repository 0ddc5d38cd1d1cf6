"""Layer-norm forward yardstick on one card: ``layer_norm_fwd`` on each
route a checkout of the port offers, beside ``F.layer_norm``, at the nd
lane's rows (16384, 768) in float32 and bf16, from several checkouts in
turns, in one call.

    python3 tools/ln_fwd_yardstick.py DIR [DIR ...]

Each checkout runs in a process of its own from its root (which builds its
own kernels), in the order given, by ``ab_runner.run_in_turns``. Its
routes are the wrapper's own rule ("kernel") and, where the wrapper takes
``_route``, the first design forced (``_route="warp"``); the library call
is ``F.layer_norm`` on the same x with gamma and beta in x's type. Each is
read by ``chip_smoke._in_turns`` (device, graph and event ms and host µs,
two rounds), x rotated through copies beyond the 50 MB L2
(``chip_smoke._Rotation``). Prints one line per checkout, {"<type>":
{"bound_ms", "kernel"|"warp"|"library": {means}}} under "checkout", and
the card's name and power limit; exits 1 if a run fails.
"""
import sys

from ab_runner import run_in_turns

CHILD = r'''
import inspect
import json
import torch
import chip_smoke as cs
from incubator_mxnet_tpu_torch.ops.cuda import common, layer_norm as ln
common.kernel_library()
F = torch.nn.functional
g = torch.Generator(device="cuda").manual_seed(0)
n, d = 16384, 768
routes = {"kernel": {}}
if "_route" in inspect.signature(ln.layer_norm_fwd).parameters:
    routes["warp"] = {"_route": "warp"}
out = {}
for dt in (torch.float32, torch.bfloat16):
    x = torch.randn((n, d), generator=g, device="cuda").to(dt)
    gam = torch.randn((d,), generator=g, device="cuda")
    bet = torch.randn((d,), generator=g, device="cuda")
    gl, bl = gam.to(dt), bet.to(dt)
    rot = cs._Rotation(x, x)

    def call(kw):
        return lambda: rot(lambda xx, _: ln.layer_norm_fwd(xx, gam, bet,
                                                           **kw))
    calls = {label: call(kw) for label, kw in routes.items()}
    calls["library"] = lambda: rot(
        lambda xx, _: F.layer_norm(xx, (d,), gl, bl, 1e-5))
    wrappers = {label: ln.layer_norm_fwd for label in routes}
    wrappers["library"] = None
    res = cs._in_turns(calls, wrappers)
    moved = 2 * n * d * x.element_size() + 2 * d * 4 + 2 * n * 4
    out[str(dt)[6:]] = {"bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3,
                        **{k: {m: v for m, v in r.items()
                               if not m.endswith("_rounds")}
                           for k, r in res.items()}}
    del rot, x
print("RESULT " + json.dumps(out), flush=True)
'''


def main(dirs) -> int:
    return run_in_turns(CHILD, dirs, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
