"""Parallelism of the PyTorch port: the mesh on ``torch.distributed``
(``mesh``), its collectives, tensor parallelism (``tp``), the pipeline,
the expert-parallel MoE, ring and Ulysses attention, and the functional
train step (``dp``), on one card or as a per-rank program on a mesh."""
from . import collectives  # noqa: F401
from . import pipeline  # noqa: F401
from . import tp  # noqa: F401
from . import ulysses  # noqa: F401
from .mesh import (MeshConfig, create_mesh, get_mesh,  # noqa: F401
                   set_mesh)
from .moe import moe_layer_dense, moe_layer_sharded, top1_gating
from . import ring_attention  # noqa: F401
from .ring_attention import (attention_reference, ring_attention_sharded,
                             ring_flash_attention_sharded)

__all__ = ["attention_reference", "moe_layer_dense", "moe_layer_sharded",
           "top1_gating", "ring_attention_sharded",
           "ring_flash_attention_sharded", "MeshConfig", "create_mesh",
           "get_mesh", "set_mesh", "collectives", "pipeline", "tp",
           "ulysses"]
