"""repro_torch.data — the counterpart of ``repro.data``'s classification
data (``synthetic``). The LM streams (``repro.data.lm``) and the modality
stubs wait on the LM trainer (``ROADMAP.md``, queue 1, item 5)."""
from repro_torch.data.synthetic import (Dataset, NodeSampler,
                                        make_classification,
                                        make_device_sampler, shard_to_nodes,
                                        shard_to_nodes_noniid,
                                        train_val_split)

__all__ = ["Dataset", "NodeSampler", "make_classification",
           "make_device_sampler", "shard_to_nodes", "shard_to_nodes_noniid",
           "train_val_split"]
