from repro_torch.sharding.rules import (P, PartitionSpec, batch_pspecs,
                                        cache_pspecs, local_shape,
                                        param_pspecs, to_placements)

__all__ = ["P", "PartitionSpec", "batch_pspecs", "cache_pspecs",
           "local_shape", "param_pspecs", "to_placements"]
