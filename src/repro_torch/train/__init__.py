"""repro_torch.train — the decentralized bilevel LM trainer, the
counterpart of ``repro.train``."""
from repro_torch.train.bilevel_lm import make_lm_bilevel_problem, x_dim
from repro_torch.train.decentral import (TrainerConfig, make_mix,
                                         make_node_batch, make_problem,
                                         make_step_batch, make_step_fns,
                                         make_trainer_engine, n_nodes,
                                         node_axis_name, node_keys_spec,
                                         state_shape, step_batch_specs)

__all__ = ["TrainerConfig", "make_lm_bilevel_problem", "make_mix",
           "make_node_batch", "make_problem", "make_step_batch",
           "make_step_fns", "make_trainer_engine", "n_nodes",
           "node_axis_name", "node_keys_spec", "state_shape",
           "step_batch_specs", "x_dim"]
