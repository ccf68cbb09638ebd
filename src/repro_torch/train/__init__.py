from .compress import (compressed_pmean_tree, compressed_psum, dequantize,
                       quantize)
from .ddp import build_ddp_train_step
from .loop import (SimulatedFailure, TrainConfig, TrainResult,
                   build_grad_fn, build_train_step, sync_grads, train,
                   train_with_restarts)
from .optimizer import (AdamWConfig, abstract_opt_state, adamw_update,
                        init_opt_state, opt_state_axes, schedule, zero_dims)

__all__ = ["AdamWConfig", "SimulatedFailure", "TrainConfig", "TrainResult",
           "abstract_opt_state", "adamw_update", "build_ddp_train_step",
           "build_grad_fn", "build_train_step", "compressed_pmean_tree",
           "compressed_psum", "dequantize", "init_opt_state",
           "opt_state_axes", "quantize", "schedule", "sync_grads", "train",
           "train_with_restarts", "zero_dims"]
