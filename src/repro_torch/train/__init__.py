"""The training substrate: AdamW and momentum-SGD with f32 master
weights, the train step with microbatch accumulation, and LINVIEW's
low-rank gradient compression (also used by the learning views,
:mod:`repro_torch.fivm`)."""

from .grad_compression import (CompressionState, compress_leaf,
                               compress_tree, compressed_psum,
                               compression_ratio,
                               compression_state_from_numpy, decompress_leaf,
                               decompress_tree, init_compression)
from .optimizer import (OptState, adamw_init, adamw_update, cosine_schedule,
                        global_norm, opt_state_axes, opt_state_from_numpy,
                        sgdm_init, sgdm_update)
from .train_step import (TrainState, init_train_state, make_train_step,
                         require_grad, train_state_specs)

__all__ = ["CompressionState", "OptState", "TrainState", "adamw_init",
           "adamw_update", "compress_leaf", "compress_tree",
           "compressed_psum", "compression_ratio", "compression_state_from_numpy",
           "cosine_schedule", "decompress_leaf", "decompress_tree",
           "global_norm", "init_compression", "init_train_state",
           "make_train_step", "opt_state_axes", "opt_state_from_numpy",
           "require_grad", "sgdm_init", "sgdm_update", "train_state_specs"]
