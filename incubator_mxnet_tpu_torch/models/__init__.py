"""Models of the PyTorch port."""
from .transformer import (TransformerConfig, init_transformer_params,
                          make_transformer_train_step, opt_state_from_jax,
                          params_from_jax, transformer_forward,
                          transformer_loss_and_grads)

__all__ = ["TransformerConfig", "init_transformer_params",
           "make_transformer_train_step", "opt_state_from_jax",
           "params_from_jax", "transformer_forward",
           "transformer_loss_and_grads"]
