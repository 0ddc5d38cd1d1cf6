"""Some phases of ``chip_smoke.py`` alone, on one card (a quicker check
of the paths they drive than the whole script):

    python3 tools/chip_phases.py 27 28 29 30     # the fed lanes (~3 min)
    python3 tools/chip_phases.py 17 20           # the LSTM and detection
                                                 # kernels' checks
    python3 tools/chip_phases.py 31              # the fused trainer step
    python3 tools/chip_phases.py 32              # the mesh (8 gloo ranks
                                                 # on the card, 1 NCCL)

It builds the kernels, runs each named phase in turn with its inputs
from the phases it would follow left out (their img/s logged as None)
and a fresh record of the kernels, logs the card's name and power
limit, each phase's seconds and the memory held after it, and prints
the seconds as its last line.
"""
import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from tools import chip_mesh  # noqa: E402


def main(names) -> int:
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.ops.cuda import common
    from incubator_mxnet_tpu_torch.ops.cuda import detection as kd
    from incubator_mxnet_tpu_torch.ops.cuda import lstm as lt
    phases = {
        "17": lambda: cs.lstm_kernel_checks(lt, common),
        "20": lambda: cs.detection_kernel_checks(kd, common),
        "27": lambda: cs.detection_input_phase(mx, common, records, None),
        "28": lambda: cs.input_service_phase(mx, gluon, vision, common,
                                             records, None, None),
        "29": lambda: cs.zoo_serving_phase(mx, vision),
        "30": lambda: cs.bucketed_lm_phase(mx, common, records),
        "31": lambda: cs.fused_step_phase(mx, gluon, vision, common,
                                          records),
        "32": lambda: chip_mesh.mesh_phase(cs.log, records)}
    unknown = [n for n in names if n not in phases]
    if not names or unknown:
        print(__doc__ + f"\nphases: {sorted(phases)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    common.kernel_library()
    cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    records = collections.defaultdict(dict)
    secs = {}
    for name in names:
        t0 = time.perf_counter()
        phases[name]()
        secs[name] = time.perf_counter() - t0
        cs.log(f"phase {name} done in {secs[name]:.1f} s")
        cs._memory_held(f"phase {name}")
    cs.log(f"launch records {json.dumps(records)}")
    print(json.dumps({"seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
