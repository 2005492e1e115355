"""Distribution layer (counterpart of `vcs_h264_tpu/parallel/`): the GOP
axis across processes. GOPs are independent, so processes encode disjoint
GOP spans into a shared checkpoint directory, and rank 0 assembles the
stream from it (`distributed.py`). The row tiles with halo exchange of the
JAX package's `spatial.py` and `mesh.py` are not ported yet."""

from vcs_h264_tpu_torch.parallel.distributed import (assign_gops,
                                                     encode_distributed,
                                                     frame_range_for_gops,
                                                     init_distributed,
                                                     merge_checkpoint_dirs,
                                                     process_barrier)

__all__ = ["assign_gops", "encode_distributed", "frame_range_for_gops",
           "init_distributed", "merge_checkpoint_dirs", "process_barrier"]
