"""The float32 yardstick of the fused-conv kernels (B7) and of the LSTM
backward with a float32 W_hh (B8), on one card, from one or more checkouts
of the port in turns.

    python3 tools/conv_f32_yardstick.py DIR_A [DIR_B ...]

Each checkout runs in a process of its own from its root (which builds its
own kernels), by ``ab_runner.run_in_turns``. There, every float32 conv
form of ResNet-50's stage 3 at batch 128 (``chip_smoke._stage_runs``: the
two 1x1 forwards and backwards of block 0, the dual dgrad, a middle
block's entry conv1, 3x3 and expand conv3) is called on the route that
checkout's wrapper picks, and read four ways: torch.profiler's device ms
of one call (``device_ms``, every kernel the call launches), one call
replayed from a CUDA graph (``graph_ms``), CUDA events over a loop of
calls, and the wrapper's host µs; a form whose route is not the SIMT
kernels' is read the same four ways forced onto them (``_route="simt"``)
under "simt". Beside them: the library call's ms
(``torch.matmul`` / ``F.conv2d``, TF32 off for both) and the names of the
kernels it launches, and three bounds: the bytes (every input read once,
every output written once) at 3.35 TB/s, the flops at float32's 67
TFLOP/s (the FMA bound) and six bf16 products at 989 TFLOP/s (the bound of
a float32 product on the tensor cores with both operands in three
pieces). Then ``lstm_bwd`` with a float32 W_hh and float32 carries at the
word LM's N 128, H 650 on the route that checkout's wrapper picks (with W's
copy where that route reads one) and, when that is not the SIMT kernel,
again forced onto it, the same four readings each, beside cuDNN's
backward per step.

Prints one line per checkout, {form: reading} under "checkout", then the
card's name and power limit; exits 1 if a run fails.
"""
import sys

from ab_runner import run_in_turns

CHILD = r'''
import json
import torch
import chip_smoke as cs
from incubator_mxnet_tpu_torch.ops.cuda import common, conv_fused as cf
from incubator_mxnet_tpu_torch.ops.cuda import lstm as lt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
common.kernel_library()
g = torch.Generator(device="cuda").manual_seed(cs.SEED)
out = {}


def lib_kernels(fn):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def readings(fn, wrapper):
    dev, split = cs.device_ms(fn, wrapper)
    return {"device_ms": dev, "kernels_ms": split,
            "graph_ms": cs.graph_ms(fn),
            "event_ms": cs.time_ms(fn, iters=10, warmup=2),
            "host_us": cs.host_us(fn)}


for name, case, kern, old, _plain, lib, _moved, full, flops in \
        cs._stage_runs(cf, g, 3, torch.float32):
    fn = getattr(cf, name)
    before = {k: getattr(fn, k, 0) for k in ("sm90_launches",
                                             "x3_launches")}
    kern()
    torch.cuda.synchronize()
    route = ("sm90x3" if getattr(fn, "x3_launches", 0) > before["x3_launches"]
             else "sm90" if fn.sm90_launches > before["sm90_launches"]
             else "simt")
    t_bytes = full / cs.HBM_BYTES_PER_S * 1e3
    out[f"{name} {case}"] = {
        "route": route, **readings(kern, fn),
        "simt": readings(old, fn) if route != "simt" else None,
        "library_ms": cs.time_ms(lib, iters=10, warmup=2),
        "library_kernels": lib_kernels(lib),
        "bytes_bound_ms": t_bytes,
        "fma_bound_ms": max(t_bytes, flops / 67e12 * 1e3),
        "six_product_bound_ms": max(t_bytes, 6 * flops / 989e12 * 1e3)}
    print(f"{name} {case}: {json.dumps(out[f'{name} {case}'])}",
          flush=True)
    torch.cuda.empty_cache()

f32 = torch.float32
N, H, T = cs.LM_N, cs.LM_H, cs.LM_T
xp, h, c, w, b, dh1, dc1 = cs._lstm_operands(g, f32, f32, f32, N, H)
gates = lt.lstm_fwd_gates(xp, h, c, w, b, _route="simt")[2]


route = lt.lstm_bwd_route(w)
wp = lt.lstm_tc_weight(w) if route == "sm90" else None


def bwd():
    return lt.lstm_bwd(gates, c, c, w, dh1, dc1, w_packed=wp)


def bwd_simt():
    return lt.lstm_bwd(gates, c, c, w, dh1, dc1, _route="simt")


def lstm_readings(fn):
    dev, split = cs.device_ms(fn, lt.lstm_bwd)
    return {"device_ms": dev, "kernels_ms": split, "graph_ms": cs.graph_ms(fn),
            "event_ms": cs.time_ms(fn, iters=50), "host_us": cs.host_us(fn)}


moved, flops, prod = cs._lstm_bytes_flops(f32, f32, f32, N, H, "lstm_bwd",
                                          route)
out["lstm_bwd f32 W, f32 carries"] = {
    "route": route, **lstm_readings(bwd),
    "simt": lstm_readings(bwd_simt) if route != "simt" else None,
    "cudnn_bwd_per_step_ms": cs._cudnn_lstm_per_step(f32, T, N, H)[
        "lstm_bwd"],
    "bound_ms": max(moved / cs.HBM_BYTES_PER_S * 1e3,
                    flops / cs.PEAK_FLOPS[prod] * 1e3)}
print("RESULT " + json.dumps(out), flush=True)
'''


def main(dirs) -> int:
    return run_in_turns(CHILD, dirs, __doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
