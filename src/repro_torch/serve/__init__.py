from repro_torch.serve.batch import (BlockAllocator, BlockPool, PrefixIndex,
                                     PrefixMatch, copy_block, gather_pages,
                                     gather_slot, init_slot_cache,
                                     scatter_token, scatter_tokens,
                                     slice_token, tail_targets,
                                     tail_targets_multi, write_prefill,
                                     write_slot)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.spec import SpecConfig, make_spec_decode
from repro_torch.serve.steps import (make_decode_step, make_fused_decode,
                                     make_paged_decode,
                                     make_paged_kernel_decode,
                                     make_prefill_step, make_slot_decode_step)

__all__ = ["BlockAllocator", "BlockPool", "PrefixIndex", "PrefixMatch",
           "Request", "ServeEngine", "SlotScheduler", "SpecConfig",
           "copy_block", "gather_pages", "gather_slot", "init_slot_cache",
           "make_decode_step", "make_fused_decode", "make_paged_decode",
           "make_paged_kernel_decode", "make_prefill_step",
           "make_slot_decode_step", "make_spec_decode", "scatter_token",
           "scatter_tokens", "slice_token", "tail_targets",
           "tail_targets_multi", "write_prefill", "write_slot"]
