"""int8 serving A/B on one card: ``chip_smoke.py``'s phase 25
(``int8_serving_phase``) from two checkouts of the port in turns (A B B
A), each run then replaying two CUDA graphs of int8 products at once on
two streams against their twins (after the phase, since a checkout whose
kernels share state across streams may leave it corrupted).

    python3 tools/int8_ab.py DIR_A DIR_B

Each checkout (a directory holding ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/``, e.g. a ``git archive`` of the parent
commit unpacked where ``.gitignore`` lists) runs in a process of its own
from its root, which builds its own kernels (``ab_runner.run_in_turns``).
The concurrency check is this checkout's ``chip_smoke._qconcurrent_replays``
run on the checkout's kernels, over a seeded ResNet-50 sequence at batch 1
and 32 (per stage the stride-2 entry 1x1 and downsample, then a 1x1, the
3x3 and the expanding 1x1, requantize epilogue with bias; the head's GEMM
raw): {batch: its summary, or the message of the values off their twins}.
Phase 25 gives, per checkout, the int8 and float32 bucket graphs' ms, img/s
at 64 clients, and the 53 convs and the head on each route in turns
(device and graph ms, buckets 32 and 1). Prints one JSON line per run and
the card's name and power limit; exits 1 if a run fails.
"""
import sys
from pathlib import Path

from ab_runner import run_in_turns

CHILD = r'''
import importlib.util
import json
import torch
import chip_smoke as cs
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import quantized as qk

spec = importlib.util.spec_from_file_location("int8_check", @CHECK@)
check = importlib.util.module_from_spec(spec)
spec.loader.exec_module(check)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
common.kernel_library()
g = torch.Generator(device="cuda")
g.manual_seed(7)


def resnet_products(n):
    out, prev, cl = [], 64, torch.channels_last
    for mid, cout, h in ((64, 256, 56), (128, 512, 28), (256, 1024, 14),
                         (512, 2048, 7)):
        hin, st = (h, (1, 1)) if prev == 64 else (2 * h, (2, 2))
        for xs, ws, s, pd in (
                ((n, prev, hin, hin), (mid, prev, 1, 1), st, (0, 0)),
                ((n, prev, hin, hin), (cout, prev, 1, 1), st, (0, 0)),
                ((n, cout, h, h), (mid, cout, 1, 1), (1, 1), (0, 0)),
                ((n, mid, h, h), (mid, mid, 3, 3), (1, 1), (1, 1)),
                ((n, mid, h, h), (cout, mid, 1, 1), (1, 1), (0, 0))):
            x, w, b = check._rand_case(g, xs, ws, ws[0], True)
            out.append(("conv", (x.contiguous(memory_format=cl),
                                 w.contiguous(memory_format=cl), s, pd,
                                 (1, 1), 1),
                        qk.Requant(b, True, 3.1e-5, 141.1, False)))
        prev = cout
    x, w, _ = check._rand_case(g, (n, 2048), (1000, 2048), 1000, False)
    return out + [("gemm", (x, w), None)]


res = cs.int8_serving_phase(mx, gluon, vision, common, {})
concurrent = {}
for n in (1, 32):
    try:
        concurrent[n] = check._qconcurrent_replays(qk, resnet_products(n))
    except AssertionError as err:
        concurrent[n] = str(err)
seq, gemm = res["kernels"]["seq"], res["kernels"]["gemm"]
keys = ("device_ms", "graph_ms")
print("RESULT " + json.dumps({
    "concurrent": concurrent,
    "bucket_graph_ms": res["bucket_graph_ms"],
    "img_per_s": {k: res["resnet_loop"][k]["img_per_s"]
                  for k in ("int8", "float32")},
    "convs": {b: {r: {k: seq[b][r][k] for k in keys} for r in seq[b]}
              for b in seq},
    "head": {b: {r: {k: gemm[b]["turns"][r][k] for k in keys}
                 for r in gemm[b]["turns"]} for b in gemm}},
    default=str), flush=True)
'''


def main(dirs) -> int:
    if len(dirs) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smoke = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    return run_in_turns(CHILD.replace("@CHECK@", repr(str(smoke))), dirs,
                        __doc__, mirror=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
