"""Models of the PyTorch port."""
from .transformer import (TransformerConfig, init_transformer_params,
                          make_transformer_train_step, opt_state_from_jax,
                          params_from_jax, transformer_forward,
                          transformer_loss_and_grads)
from .ssd import (SSD, SSDMultiBoxLoss, ssd_300_vgg16_atrous,
                  ssd_512_resnet50_v1, ssd_toy)
from .word_lm import RNNModel
from .sparse_recommenders import (DLRM, FactorizationMachine,
                                  ShardedFactorizationMachine, WideDeep)

__all__ = ["DLRM", "FactorizationMachine", "RNNModel", "SSD",
           "ShardedFactorizationMachine", "WideDeep", "SSDMultiBoxLoss", "TransformerConfig",
           "init_transformer_params", "make_transformer_train_step",
           "opt_state_from_jax",
           "params_from_jax", "ssd_300_vgg16_atrous", "ssd_512_resnet50_v1",
           "ssd_toy", "transformer_forward", "transformer_loss_and_grads"]
