"""Local launcher: start N worker processes of one ``torch.distributed``
world on this host.

Counterpart of the reference launcher's local mode (``tools/launch.py``):

    python -m incubator_mxnet_tpu_torch.tools.launch -n 4 python train.py

Each child gets the reference's contract, ``MXTPU_NUM_WORKERS``,
``MXTPU_WORKER_RANK`` and ``MXTPU_COORDINATOR`` (``host:port``), and
``torch.distributed``'s rendezvous environment for the same world:
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator's). A worker joins
with ``parallel.mesh.init_world()`` (or ``create_mesh``), which reads
them. The fault-tolerance settings every rank must share
(``MXTPU_CHAOS``, ``MXTPU_GUARD_*``, ...) are inherited, as local children
inherit the environment. The launcher waits for every worker; when one
fails, the others are stopped, and its exit code is the first nonzero
one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

__all__ = ["launch_local", "main"]


def launch_local(n: int, cmd, coordinator: str = "127.0.0.1:49875",
                 chaos=None, poll_s: float = 0.1) -> int:
    """Run ``cmd`` as ``n`` ranks of one world; returns the job's exit
    code (0 when every rank exits 0)."""
    host, _, port = coordinator.rpartition(":")
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update({
            "MXTPU_NUM_WORKERS": str(n), "MXTPU_WORKER_RANK": str(rank),
            "MXTPU_COORDINATOR": coordinator, "WORLD_SIZE": str(n),
            "RANK": str(rank), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": host or "127.0.0.1",
            "MASTER_PORT": port})
        if chaos:
            env["MXTPU_CHAOS"] = chaos
        procs.append(subprocess.Popen(list(cmd), env=env))
    code = 0
    live = list(procs)
    while live:
        for p in list(live):
            rc = p.poll()
            if rc is None:
                continue
            live.remove(p)
            if rc and not code:
                code = rc
                for q in live:          # a lost rank would hang the rest
                    q.terminate()
        if live:
            time.sleep(poll_s)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, default=1)
    ap.add_argument("--launcher", choices=["local"], default="local")
    ap.add_argument("--coordinator", default="127.0.0.1:49875",
                    help="host:port of the rendezvous (rank 0 listens)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection plan forwarded to every rank as "
                         "MXTPU_CHAOS")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    return launch_local(args.num_workers, args.command, args.coordinator,
                        chaos=args.chaos)


if __name__ == "__main__":
    sys.exit(main())
