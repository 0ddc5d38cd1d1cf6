"""The bf16 flash-attention forward (B1) beside its library call, on one
card, from one or more checkouts of the port in turns.

    python3 tools/flash_bf16_yardstick.py DIR_A [DIR_B ...]

Each checkout runs in a process of its own from its root (which builds its
own kernels), by ``ab_runner.run_in_turns``. There, at the training lane's
shape (B 32, H 12, T 512, d 64, causal, bf16) in the packed layout (the
QKV projection's, which the LM takes) and the head-major one, each route
of ``flash_fwd`` that checkout offers (the default one, and the WMMA
kernel behind ``_route="wmma"`` where the wrapper takes it) and
``scaled_dot_product_attention`` on the same values (head-major, its own
layout) are read four ways, in turns over two rounds (the order reversed
in the second): torch.profiler's device ms of one call (every kernel the
call launches, over five calls), one call replayed from a CUDA graph, CUDA
events over a loop of calls, and the host µs of one call. Beside them:
the bound (q, k, v read once, out and lse written once, at 3.35 TB/s, or
the causal products at 989 TFLOP/s, whichever is larger) and the kernels
SDPA launched.

Prints one line per checkout, {case: {label: reading}} under "checkout",
then the card's name and power limit; exits 1 if a run fails.
"""
import sys

from ab_runner import run_in_turns

CHILD = r'''
import json
import torch
import chip_smoke as cs
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
common.kernel_library()
B, H, T, d = 32, 12, 512, 64
g = torch.Generator(device="cuda").manual_seed(cs.SEED)
hm = [torch.randn((B, H, T, d), generator=g, device="cuda").to(
    torch.bfloat16) for _ in range(3)]
packed = [x.transpose(1, 2).reshape(B, T, H * d).contiguous() for x in hm]
sdpa = torch.nn.functional.scaled_dot_product_attention


# its own turns and device time, not chip_smoke's _in_turns: a checkout
# from before the bf16 forward's Hopper kernel times no library call there
def dev_ms(fn, calls=5):
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev, _ = cs._device_events(window)
    if dev is None:
        return None, {}
    split = {e.key[:60]: e.self_device_time_total / calls / 1e3
             for e in dev}
    return sum(split.values()), split


def takes(route):
    try:
        fa.flash_fwd(*packed, causal=True, n_heads=H, _route=route)
    except ValueError:
        return False
    return True


routes = {"default": None}
if takes("wmma"):
    routes["wmma"] = "wmma"
pairs = T * (T + 1) // 2 * B * H
bound = max((4 * B * H * T * d * 2 + B * H * T * 4) / cs.HBM_BYTES_PER_S,
            4 * d * pairs / 989e12) * 1e3
out = {"bound_ms": bound, "routes": {
    label: fa.flash_train_route(torch.bfloat16) if r is None else r
    for label, r in routes.items()}}
for layout, ops, kw in (("packed", packed, dict(n_heads=H)),
                        ("head-major", hm, {})):
    calls = {label: (lambda r=r: fa.flash_fwd(*ops, causal=True, _route=r,
                                              **kw))
             for label, r in routes.items()}
    calls["sdpa"] = lambda: sdpa(*hm, is_causal=True)
    reads = {label: {"device_ms": [], "graph_ms": [], "event_ms": [],
                     "host_us": []} for label in calls}
    split = {}
    labels = list(calls)
    for i in range(2):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            fn = calls[label]
            dev, split[label] = dev_ms(fn)
            reads[label]["device_ms"].append(dev)
            reads[label]["graph_ms"].append(cs.graph_ms(fn))
            reads[label]["event_ms"].append(cs.time_ms(fn))
            reads[label]["host_us"].append(cs.host_us(fn))
    res = {}
    for label, got in reads.items():
        rec = {"kernels": split[label]}
        for k, vals in got.items():
            seen = [v for v in vals if v is not None]
            rec[k] = sum(seen) / len(seen) if seen else None
            rec[k + "_rounds"] = vals
        res[label] = rec
    out[layout] = res
    print(f"{layout}: {json.dumps(res)}", flush=True)
print("RESULT " + json.dumps(out), flush=True)
'''


def main(dirs) -> int:
    return run_in_turns(CHILD, dirs, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
