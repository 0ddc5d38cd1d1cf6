"""Command-line tools of the port: ``python -m
incubator_mxnet_tpu_torch.tools.serve`` (the HTTP model server)."""
