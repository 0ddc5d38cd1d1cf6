"""The server role's bootstrap (ref: python/mxnet/kvstore_server.py).

Counterpart of ``incubator_mxnet_tpu/kvstore_server.py``. The reference
blocks a "server" process in ps-lite's request loop and lets workers ship
it a pickled optimizer (command 0). Here the synchronous types sum over
``torch.distributed`` and the async type's server is rank 0's socket loop
(``_ps.py``): no process is a server alone. For launch scripts that set
``MXTPU_ROLE=server`` (the reference's ``DMLC_ROLE=server``),
:class:`KVStoreServer` joins the world so barriers count it, applies an
optimizer command, and returns when the workers are done.
"""
from __future__ import annotations

import logging
import os
import pickle


class KVStoreServer(object):
    """(ref: kvstore_server.py:28 KVStoreServer)"""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging = False

    def _controller(self):
        def server_controller(cmd_id, cmd_body, _=None):
            if not self.init_logging:
                head = ("%(asctime)-15s Server[" +
                        str(self.kvstore.rank) + "] %(message)s")
                logging.basicConfig(level=logging.DEBUG, format=head)
                self.init_logging = True
            if cmd_id == 0:
                optimizer = pickle.loads(cmd_body)
                self.kvstore.set_optimizer(optimizer)
            else:
                print("server %d, unknown command (%d, %s)" % (
                    self.kvstore.rank, cmd_id, cmd_body))
        return server_controller

    def run(self):
        """Take part in the job until the workers finish: the start-up
        barrier (ps::Postoffice::Start) and the shut-down barrier."""
        self.kvstore.barrier()
        self.kvstore.barrier()


def _init_kvstore_server_module():
    """Block a server-role process (ref: kvstore_server.py:76); the role
    comes from ``MXTPU_ROLE`` (the launcher's ``DMLC_ROLE``)."""
    if os.environ.get("MXTPU_ROLE") == "server":
        from .kvstore import create
        server = KVStoreServer(create("dist"))
        server.run()
        import sys
        sys.exit()


_init_kvstore_server_module()
