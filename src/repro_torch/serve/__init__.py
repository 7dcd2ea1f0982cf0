from repro_torch.serve.batch import (BlockAllocator, BlockPool, PrefixIndex,
                                     PrefixMatch, copy_block, tail_targets,
                                     write_prefill)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.steps import make_paged_kernel_decode, make_prefill_step

__all__ = ["BlockAllocator", "BlockPool", "PrefixIndex", "PrefixMatch",
           "Request", "ServeEngine", "SlotScheduler", "copy_block",
           "make_paged_kernel_decode", "make_prefill_step", "tail_targets",
           "write_prefill"]
