"""repro_torch.data — the counterpart of ``repro.data``: the classification
data and the modality stubs (``synthetic``) and the LM token streams and
step batches (``lm``)."""
from repro_torch.data.lm import (lm_batch_extras, make_device_lm_sampler,
                                 make_lm_step_batch, make_node_batch)
from repro_torch.data.synthetic import (Dataset, NodeSampler, audio_stub,
                                        lm_batch, make_classification,
                                        make_device_sampler, shard_to_nodes,
                                        shard_to_nodes_noniid,
                                        train_val_split, vision_stub)

__all__ = ["Dataset", "NodeSampler", "audio_stub", "lm_batch",
           "lm_batch_extras",
           "make_classification", "make_device_lm_sampler",
           "make_device_sampler", "make_lm_step_batch", "make_node_batch",
           "shard_to_nodes", "shard_to_nodes_noniid", "train_val_split",
           "vision_stub"]
