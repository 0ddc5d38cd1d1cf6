"""The bf16 flash-attention forward (B1) and backward pair (B2: dq, then
dk/dv) beside their library calls, on one card, from one or more
checkouts of the port in turns.

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
SDPA launched. Then the backward at the same shape and layouts, from the
forward's lse and delta = sum(dout * out) per head: ``flash_bwd_dq``,
``flash_bwd_dkv`` and the pair (both, one after the other) on each route
that checkout's wrappers offer (the default one, and the WMMA kernels
behind ``_route="wmma"`` where the wrappers take it), and SDPA's backward
(``torch.autograd.grad`` through ``scaled_dot_product_attention``,
head-major, its output kept from one forward), read the same four ways in
turns, beside the pair's bound (q, k, v, dout, lse and delta read once,
dq, dk and dv written once, or 10 d flops a causal pair at the bf16 peak).

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


def takes(route, kern=fa.flash_fwd, *rest):
    try:
        kern(*packed, *rest, causal=True, n_heads=H, _route=route)
    except ValueError:
        return False
    return True


def safe_graph_ms(fn):
    # an autograd backward may refuse capture on a side stream
    try:
        return cs.graph_ms(fn)
    except Exception:                                   # noqa: BLE001
        torch.cuda.synchronize()
        return None


def in_turns(calls):
    reads = {label: {"device_ms": [], "graph_ms": [], "event_ms": [],
                     "host_us": []} for label in calls}
    split = {}
    labels = list(calls)
    for i in range(2):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            fn = calls[label]
            dev, split[label] = dev_ms(fn)
            reads[label]["device_ms"].append(dev)
            reads[label]["graph_ms"].append(safe_graph_ms(fn))
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
    return res


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
    res = in_turns(calls)
    out[layout] = res
    print(f"{layout}: {json.dumps(res)}", flush=True)

# the backward pair from the forward's lse and delta
dout_hm = torch.randn((B, H, T, d), generator=g, device="cuda").to(
    torch.bfloat16)
dout_p = dout_hm.transpose(1, 2).reshape(B, T, H * d).contiguous()
fo, flse = fa.flash_fwd(*packed, causal=True, n_heads=H)
bwd_routes = {"default": None}
delta_p = (dout_p.float() * fo.float()).view(B, T, H, d).sum(-1)
if takes("wmma", fa.flash_bwd_dq, dout_p, flse, delta_p):
    bwd_routes["wmma"] = "wmma"
out["bwd_routes"] = {
    label: fa.flash_train_route(torch.bfloat16, "flash_bwd_dq")
    if r is None else r for label, r in bwd_routes.items()}
x_bytes = B * H * T * d * 2
out["bwd_pair_bound_ms"] = max(
    (7 * x_bytes + 2 * B * H * T * 4) / cs.HBM_BYTES_PER_S,
    10 * d * pairs / 989e12) * 1e3
qr, kr, vr = (x.detach().requires_grad_(True) for x in hm)
so = sdpa(qr, kr, vr, is_causal=True)
for layout, ops, do, kw in (("packed", packed, dout_p, dict(n_heads=H)),
                            ("head-major", hm, dout_hm, {})):
    o, lse = fa.flash_fwd(*ops, causal=True, **kw)
    prod = do.float() * o.float()
    delta = prod.view(B, T, H, d).sum(-1) if kw else prod.sum(-1)
    calls = {}
    for label, r in bwd_routes.items():
        args = (*ops, do, lse, delta)
        bkw = dict(kw, causal=True, _route=r)
        calls[f"dq/{label}"] = (
            lambda a=args, b=bkw: fa.flash_bwd_dq(*a, **b))
        calls[f"dkv/{label}"] = (
            lambda a=args, b=bkw: fa.flash_bwd_dkv(*a, **b))
        calls[f"pair/{label}"] = (
            lambda a=args, b=bkw: (fa.flash_bwd_dq(*a, **b),
                                   fa.flash_bwd_dkv(*a, **b)))
    calls["sdpa_bwd"] = lambda: torch.autograd.grad(
        so, (qr, kr, vr), dout_hm, retain_graph=True)
    res = in_turns(calls)
    out[f"bwd {layout}"] = res
    print(f"bwd {layout}: {json.dumps(res)}", flush=True)
print("RESULT " + json.dumps(out), flush=True)
'''


def main(dirs) -> int:
    return run_in_turns(CHILD, dirs, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
